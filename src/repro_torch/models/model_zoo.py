"""Public model API of the port's LM zoo: build a `Model` from a
ModelConfig (port of `repro.models.model_zoo`, inference part).

    model = build_model(get_arch("smollm_135m"))
    params = model.init(seed=0)                      # on "cuda"
    hidden, aux = model.prefill(params, {"tokens": tokens})

`params` is the `transformer.LM` module (weights in the config's
`param_dtype`, but for the leaves JAX keeps in fp32), on the device
`init` was given. `prefill` and `decode_step` run under
`torch.inference_mode()`; on CUDA, attention layers run `prefill`
through the flash-attention kernel (self-attention, the encoder's and
the cross-attention of an encoder-decoder, and the prefix-LM mask of a
VLM) and RWKV layers run `prefill` and
`decode_step` through the wkv kernel (one launch a layer each); the
Mamba, mLSTM and sLSTM recurrences and the MoE layers' routing and
expert products are plain PyTorch, as they are plain JAX in the
reference. `loss` is the training objective (`transformer.lm_loss`),
run with autograd on: on CUDA each attention layer's flash call saves
its log-sum-exp and its backward launches the flash backward kernel.
`param_specs` and `cache_specs` are the logical-axis specs the Trainer
and `repro_torch.distributed.sharding` read; `input_specs` describes a
workload's inputs by meta tensors (shapes and dtypes, no storage).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.device import Device, resolve_device
from repro_torch.models import transformer as tfm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # -------------------------------------------------------------- params
    def init(self, seed: int = 0, device: Device = "cuda") -> tfm.LM:
        """The model's parameters, drawn on the CPU from
        `torch.Generator(seed)` (so one seed gives the same weights on
        every device), each block moved to `device` as soon as it is
        drawn."""
        return tfm.LM(self.cfg, seed, device=resolve_device(device))

    def param_specs(self) -> Dict[str, tuple]:
        """{"/"-joined parameter name: logical axes}, read from the config
        alone (`transformer.lm_param_specs`)."""
        return tfm.lm_param_specs(self.cfg)

    # --------------------------------------------------------------- train
    def loss(self, params: tfm.LM, batch: Dict[str, Any],
             remat: str = "none", label_smoothing: float = 0.0):
        """(loss, {"nll", "aux"}) of `transformer.lm_loss` on `batch`
        (tokens, and frames or patches as `prefill` takes them), moved to
        the params' device; grad mode as the caller has it, so that
        `loss.backward()` or `torch.autograd.grad` reaches every
        parameter. `remat`: "none", "dots" or "full"
        (`transformer.remat_wrap`)."""
        dev = _device(params)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        return tfm.lm_loss(params, self.cfg, batch, remat=remat,
                           label_smoothing=label_smoothing)

    # --------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Device = "cuda",
                   enc_len: Optional[int] = None) -> Dict[str, Any]:
        """Zeroed decode cache: KV (and an encoder-decoder's cross KV of
        `enc_len` positions) in `dtype`, recurrent states in fp32; its
        specs are `cache_specs`."""
        return tfm.init_cache(self.cfg, batch, max_seq, dtype,
                              resolve_device(device), enc_len=enc_len)

    def decode_step(self, params: tfm.LM, cache, tokens, pos,
                    write: Optional[torch.Tensor] = None):
        """(logits (B,1,V) fp32, cache): one token per row; the cache is
        updated in place (see `transformer.lm_decode_step`)."""
        with torch.inference_mode():
            tokens = torch.as_tensor(tokens, device=_device(params))
            return tfm.lm_decode_step(params, self.cfg, cache, tokens, pos,
                                      write)

    def prefill(self, params: tfm.LM, batch: Dict[str, Any]):
        """Full-sequence forward returning (hidden (B,S,d), aux): aux is
        the fp32 sum of the MoE layers' load-balance losses (0 without
        MoE layers). `batch` holds "tokens" (B, S), and "frames" (B, T,
        d) for an encoder-decoder (run through the encoder first) or
        "patches" (B, P, d), put ahead of the text (hidden is then (B, P
        + S, d))."""
        with torch.inference_mode():
            dev = _device(params)
            tokens = torch.as_tensor(batch["tokens"], device=dev)
            enc_memory = None
            if self.cfg.encoder_layers:
                enc_memory = tfm.encoder_apply(
                    params, self.cfg,
                    torch.as_tensor(batch["frames"], device=dev))
            patches = batch.get("patches")
            if patches is not None:
                patches = torch.as_tensor(patches, device=dev)
            return tfm.lm_apply(params, self.cfg, tokens,
                                prefix_embeds=patches, enc_memory=enc_memory,
                                return_hidden=True)

    # --------------------------------------------------------------- shapes
    def supports_shape(self, shape: ShapeConfig) -> bool:
        """long_500k needs sub-quadratic sequence mixing: an all-recurrent
        stack, or a hybrid whose attention is windowed or at most one
        layer in eight."""
        if shape.name == "long_500k":
            kinds = set(self.cfg.blocks())
            recurrent = {"mamba", "mlstm", "slstm"}
            n_attn = sum(1 for k in self.cfg.blocks() if k == "attn")
            if kinds <= recurrent:
                return True
            return bool(kinds & recurrent and (
                self.cfg.attn_window > 0
                or n_attn * 8 <= self.cfg.num_layers))
        return True

    def input_specs(self, shape: ShapeConfig, *, per_device_batch: int = 0
                    ) -> Dict[str, Any]:
        """Meta tensors standing in for every model input of a workload:
        for train/prefill the token batch (+ an encoder-decoder's frames,
        a VLM's patches, bf16); for decode one new token a row, the cache
        filled to seq_len (`init_cache` in bf16) and the position."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def meta(shape_, dtype):
            return torch.empty(shape_, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            specs: Dict[str, Any] = {"tokens": meta((B, S), torch.int32)}
            if cfg.encoder_layers:
                specs["frames"] = meta((B, min(S, 1500), cfg.d_model),
                                       torch.bfloat16)
            if cfg.frontend == "vision_patches":
                specs["patches"] = meta(
                    (B, cfg.num_prefix_embeddings, cfg.d_model),
                    torch.bfloat16)
            return specs
        return {"tokens": meta((B, 1), torch.int32),
                "cache": tfm.init_cache(cfg, B, S, torch.bfloat16,
                                        torch.device("meta")),
                "pos": meta((), torch.int32)}

    def cache_specs(self, shape: Optional[ShapeConfig] = None
                    ) -> Dict[str, Dict[str, tuple]]:
        """Logical-axis specs of the decode cache's tree
        (`transformer.cache_specs`; the same for every shape)."""
        return tfm.cache_specs(self.cfg)

    # ------------------------------------------------------------ analytics
    def param_count(self) -> int:
        """Number of parameters, counted from the shapes alone (the meta
        device allocates nothing)."""
        with torch.device("meta"):
            lm = tfm.LM(self.cfg)
        return sum(p.numel() for p in lm.parameters())

    def active_param_count(self) -> int:
        """Parameters touched per token: the MoE layers' inactive experts
        (num_experts - top_k of them) taken out of `param_count`."""
        total = self.param_count()
        moe = self.cfg.moe
        if moe is None:
            return total
        n_moe_layers = sum(1 for i in range(self.cfg.num_layers)
                           if self.cfg.is_moe_layer(i))
        per_expert = self.cfg.d_model * moe.d_ff * (3 if self.cfg.mlp_gated
                                                    else 2)
        return total - n_moe_layers * (moe.num_experts - moe.top_k) * \
            per_expert


def _device(params: tfm.LM) -> torch.device:
    return params.embed.table.device


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
