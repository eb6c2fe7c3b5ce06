"""Configuration of the port: its own copies of `repro.config`'s
dataclasses and arch registry, with the same fields and defaults, so one
configuration reads the same in both packages.

* `TrainConfig`: the `Trainer` reads the optimizer, schedule,
  `grad_clip`, `microbatch` and checkpoint fields; `remat`,
  `grad_compression`, `seed` and `label_smoothing` are read by neither
  package's Trainer.
* `ModelConfig` (+ `MoEConfig`) describes an LM of the zoo,
  `ShapeConfig` a workload shape. Arch configs live in
  `repro_torch/configs/<id>.py` and register themselves in `ARCHS`;
  `get_arch` resolves an id. Every arch of the zoo is ported
  (`PORTED_ARCHS`): the dense attention-only decoders, the recurrent
  archs (xlstm, the paper's encoder), the MoE archs (qwen3-moe, grok-1,
  the jamba hybrid), the encoder-decoder (whisper) and the prefix-LM VLM
  (paligemma); any other id raises a `KeyError`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

from repro_torch.utils.registry import Registry

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

# Block kinds a model is assembled from. A plain decoder-only transformer is
# ["attn"] * L; jamba interleaves ["mamba"]*7 + ["attn"] per group, etc.
BLOCK_ATTN = "attn"
BLOCK_MAMBA = "mamba"
BLOCK_MLSTM = "mlstm"
BLOCK_SLSTM = "slstm"
BLOCK_RWKV = "rwkv"  # paper Stage-1 encoder backbone


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # d_ff of each expert (may differ from dense d_ff)
    d_ff: int
    # capacity factor for expert dispatch (tokens per expert buffer sizing)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    # block pattern; None => all attention
    block_pattern: Optional[Tuple[str, ...]] = None
    moe: Optional[MoEConfig] = None
    # which layers are MoE (None => all, if moe set)
    moe_layer_stride: int = 1
    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # sliding-window size for long-context attention (0 = full/causal)
    attn_window: int = 0
    # encoder-decoder
    encoder_layers: int = 0
    cross_attention: bool = False
    # modality frontend stub: number of prefix embeddings supplied directly
    frontend: Optional[str] = None  # None | "audio_frames" | "vision_patches"
    num_prefix_embeddings: int = 0
    # ssm details
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    mlstm_head_dim: Optional[int] = None
    # mlp
    mlp_gated: bool = True  # SwiGLU if True else GELU
    # positions: "rope" | "learned" | "none" (recurrent blocks need none)
    pos_embedding: str = "rope"
    max_position: int = 1 << 20
    # prefix-LM attention (bidirectional over the prefix), used by VLM
    prefix_lm: bool = False
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # norm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # per-arch logical->mesh rule overrides (read by the distributed slice,
    # not ported yet)
    sharding_overrides: Optional[Tuple[Tuple[str, Any], ...]] = None
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def blocks(self) -> Tuple[str, ...]:
        if self.block_pattern is not None:
            assert len(self.block_pattern) == self.num_layers
            return self.block_pattern
        return tuple([BLOCK_ATTN] * self.num_layers)

    def is_moe_layer(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe_layer_stride == 0)


# ---------------------------------------------------------------------------
# Workload shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    optimizer: str = "adamw"  # adamw | adafactor
    microbatch: int = 0  # 0 = no grad accumulation
    remat: str = "none"  # none | full | dots
    # fault tolerance
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    checkpoint_dir: str = "/tmp/repro_ckpt"
    # distributed tricks
    grad_compression: str = "none"  # none | int8_ef
    seed: int = 0
    label_smoothing: float = 0.0


# ---------------------------------------------------------------------------
# Arch registry
# ---------------------------------------------------------------------------

ARCHS: Registry = Registry("architecture")

# The zoo's archs with a config module in `repro_torch/configs/`: the dense
# attention-only decoders, xLSTM, the paper's RWKV encoder, the MoE archs,
# the encoder-decoder and the VLM.
PORTED_ARCHS = ("granite_3_2b", "qwen2_7b", "qwen3_4b", "smollm_135m",
                "semanticbbv_encoder", "xlstm_1_3b",
                "qwen3_moe_235b_a22b", "grok_1_314b", "jamba_1_5_large_398b",
                "whisper_tiny", "paligemma_3b")


def canon(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_arch(arch_id: str) -> ModelConfig:
    """Resolve an arch id (dashes or underscores) to its ModelConfig."""
    import importlib

    key = canon(arch_id)
    if key not in ARCHS:
        if key not in PORTED_ARCHS:
            raise KeyError(f"arch '{arch_id}' is not ported yet (or unknown);"
                           f" ported: {list(PORTED_ARCHS)}")
        # lazy-import the config module so it self-registers
        importlib.import_module(f"repro_torch.configs.{key}")
    return ARCHS[key]()


def scaled_down(cfg: ModelConfig, num_layers: int = 2, d_model: int = 64,
                num_heads: int = 4, num_kv_heads: Optional[int] = None,
                d_ff: int = 128, vocab_size: int = 512,
                num_experts: Optional[int] = None) -> ModelConfig:
    """Family-preserving reduced config for CPU smoke tests."""
    kv = num_kv_heads if num_kv_heads is not None else max(1, num_heads // 2)
    changes: dict = dict(
        num_layers=num_layers, d_model=d_model, num_heads=num_heads,
        num_kv_heads=kv, d_ff=d_ff, vocab_size=vocab_size, head_dim=None,
        dtype="float32", param_dtype="float32",
    )
    if cfg.block_pattern is not None:
        # preserve the family's block mixture at reduced depth
        pat = list(cfg.block_pattern)
        kinds = []
        for k in dict.fromkeys(pat):  # unique, order-preserving
            kinds.append(k)
        new_pat = tuple((kinds * num_layers)[:num_layers])
        changes["block_pattern"] = new_pat
    if cfg.moe is not None:
        ne = num_experts or min(cfg.moe.num_experts, 4)
        changes["moe"] = MoEConfig(
            num_experts=ne, top_k=min(cfg.moe.top_k, 2), d_ff=d_ff,
            capacity_factor=cfg.moe.capacity_factor)
    if cfg.encoder_layers:
        changes["encoder_layers"] = min(cfg.encoder_layers, 2)
    if cfg.num_prefix_embeddings:
        changes["num_prefix_embeddings"] = min(cfg.num_prefix_embeddings, 16)
    return dataclasses.replace(cfg, **changes)
