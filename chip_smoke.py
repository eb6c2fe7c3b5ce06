#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code if it fails:
  1. setup: the card's name and power limit (nvidia-smi), and the build of
     the CUDA kernel library from src/repro_torch/csrc (seconds printed);
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes and at awkward ones, with its time, the plain
     version's time, one PyTorch call's time where one computes the same
     function, and the least time the card could take (bound); the
     set-attention forward is timed at the SAB and at the PMA shape, and
     its registers, shared memory and spills are printed; kmeans_update
     at the build's shape is bitwise equal on a second call, with other
     values in its dead rows and at twice the capacity, and both k-means
     kernels print their registers, shared memory and spills; the wkv
     backward against its plain reverse loop at Stage-1 training's shape
     and ragged ones (with an initial state and a final-state gradient),
     bitwise repeatable, the forward that writes the states bitwise the
     serving forward, its registers, shared memory and spills;
  3. the full-width models on CPU (plain versions) and on the card
     (kernels) agree on a small input: BBEs, signatures, and the Stage-2
     and Stage-1 pre-training loss gradients of every parameter;
  4. the serving path at the paper's full width (default configs, k = 14,
     seeded untrained weights): 19 SPEC-like programs x 1,000 intervals,
     INORDER CPIs; ingest blocks, ingest 18 programs, build, attach_many
     the 19th, estimate every program. Every kernel of the path must have
     launched. Then 5 more build(k=14) calls on the same store: their
     median wall time and k-means launches a build;
 4b. the store's lifecycle on phase 4's service: a vacuum whose LRU
     policy (16,000 rows) evicts the 3 least recently estimated programs
     and compacts the store (capacity 32,768 -> 16,384; the survivors'
     estimates bitwise unchanged), a rebuild on the compacted store, a
     save to build/chip_smoke_kb, then attach_intervals of an evicted
     program (a pure query); after its launches are read, the witnesses:
     the gathered matrix bitwise a fresh upload, a build on a fresh store
     of the same live rows bitwise the rebuild, and a reload in a fresh
     process (estimates bitwise summary.json's);
 4c. Fig. 4's SimPoint flow on the card for every program: classic BBVs
     projected to 15 dims and the semantic signatures of phase 4, k 10,
     with the exact k-means launches that implies; on two programs the
     card's k-means against the CPU's from the same seeds;
  5. Stage-2 training at full width on the BBEs phase 4 made: 20 steps of
     64 triplets (the paper's selection policy over the 18 ingested
     programs), a checkpoint every 10 steps, then a fresh engine restored
     from step 10 and run to step 20 must end with bitwise the same
     weights (deterministic algorithms on). Both set-attention kernels
     must have launched, the backward 9 times a step;
 5b. Stage-1 training at the paper's width (default BBEConfig, 24.9M
     parameters, seeded untrained): 20 pre-training steps (NTP + NIP) of
     64 x 128 tokens from a SyntheticBinaryCorp of 500 functions, a
     checkpoint every 10, then 10 triplet fine-tuning steps of 32
     triplets; wkv forward and backward launched 12 times a pre-training
     step and 36 a triplet step; then, after the path's launches are read,
     a fresh Trainer restored from step 10 and run to step 20 must end with
     bitwise the same weights (deterministic algorithms on);
  6. the LM zoo's dense serving path (smollm-135m at full width and
     depth, seeded untrained weights): (a) the flash-attention kernels
     against their plain version at the head dims of every zoo config (64,
     128, 256; causal, windowed, non-causal S != T, ragged fp32), at D
     80 and with the prefix rule in both dtypes (prefixes that cut a key
     tile and a query tile, with a window, past T: bitwise the full mask),
     bf16 within atol 1e-2 rtol 1e-2 and a relative L2 error of 1e-2,
     fp32 within 2e-5 / 1e-2 / 1e-4; q/k/v as views of a fused projection (16-byte loads) and at an
     odd offset (element loads), bit for bit equal to contiguous copies;
     two launches give the same bits; registers, shared memory and spills
     of each bf16 instance; the HGMMA instructions in the bf16 kernel's
     SASS (cuobjdump, where the toolkit has it); timed at smollm's prefill
     shape beside scaled_dot_product_attention; (b) fp32
     on the CPU against the card: hidden states of a 256-token prefill and
     16 greedy tokens; (c) bf16 on the card: `Model.prefill` of 8 x 2048
     tokens (30 flash launches a call), then a ServeEngine with 8 slots
     answering 24 requests twice with the same tokens; the cyclic
     collector runs before each peak-memory reading;
  7. the zoo's recurrent archs (seeded untrained weights): (a) wkv at the
     encoder's decode shape (B 8, S 1, H 6, dh 64, the state a view of a
     stacked cache) and at its prefill of 8 x 2048 tokens, against its
     plain version, timed beside its bound; (b) semanticbbv-encoder at
     full width and depth (fp32): prefill and 4 decode steps on the CPU
     against the card (12 wkv launches a call), then `Model.prefill` of 8
     x 2048 tokens and a ServeEngine (8 slots, max_seq 1024) answering 24
     requests of 16-256 prompt tokens, 64 new each, twice with the same
     tokens, exactly 12 wkv launches a prefill call and a decode step;
     (c) xlstm-1.3b at full width and depth (bf16): prefill of 4 x 2048
     tokens, a ServeEngine (8 slots, max_seq 512) answering 16 requests of
     16-128 prompt tokens, 32 new each, twice with the same tokens; then
     one period of it (8 layers) in fp32 on the CPU against the card, and
     one mLSTM layer's token scan; (d) one Mamba mixer at jamba-1.5-large's
     width (fp32), prefill and 4 decode steps, CPU against the card;
  8. the zoo's MoE archs (seeded untrained weights): (a) the bf16 flash
     kernel at qwen3-moe-235b-a22b's prefill shape (B 8, S 2048, 64 query
     heads over 4 kv heads, D 128) against its plain version, timed beside
     SDPA and its bound; (b) fp32 at full width on the CPU against the
     card: qwen3-moe cut to 1 layer (prefill of 2 x 64 tokens, its logits,
     4 decode steps, the caches) and grok-1's MoE mixer alone (2 x 64 and
     4 one-token steps), routing first (top-k experts, slots, kept pairs
     equal but for flips where the CPU's probabilities lie within
     ROUTING_ULPS, and the slots they move), then the rest on the groups
     without a flip; (c) qwen3-moe at full width and 8 of its 94 layers
     (bf16, 21,146,703,872 parameters): `Model.prefill` of 8 x 2048 tokens
     (exactly 8 flash launches a call, a finite positive aux), then a
     ServeEngine (8 slots, max_seq 512) answering 16 requests of 16-128
     prompt tokens, 32 new each, twice with the same tokens;
  9. the zoo's encoder-decoder and prefix-LM (seeded untrained weights):
     (a) prefix_len 0 bitwise the causal call at D 64, 128 and 256 in
     both kernels, the registers, shared memory and spills of every
     instance, and the bf16 kernel against its plain version (6a's
     bounds) and timed beside SDPA and its bound at whisper's
     encoder (16 x 1500 frames, full), cross (448 x 1500, full) and
     decoder (448, causal) shapes and paligemma's prefill (8 x 2048, 8
     heads over 1, D 256, prefix 256); (b) fp32 on the CPU against the
     card: whisper-tiny at full width and depth (frames 2 x 1500, tokens
     2 x 64, then 4 decode steps with the cross caches filled from the
     encoder), paligemma-3b at full width cut to 2 layers (256 patches +
     64 tokens, 4 decode steps); (c) whisper-tiny in bf16: `Model.prefill`
     of 16 x 1500 frames + 16 x 448 tokens (exactly 12 flash launches a
     call: 4 encoder, 4 decoder, 4 cross), a ServeEngine (8 slots,
     max_seq 448) answering 16 requests of 4-128 prompt tokens, 128 new
     each, twice with the same tokens; (d) paligemma-3b at full width and
     depth in bf16: `Model.prefill` of 8 x (256 patches + 1,792 tokens)
     (exactly 18 flash launches a call), a ServeEngine (8 slots, max_seq
     512) answering 16 requests of 16-128 tokens, 32 new each, twice;
 10. the zoo's training (seeded untrained weights): (a) the flash backward
     kernel against its plain version on the same q, k, v, o, dO and
     log-sum-exp at every row of FLASH_CASES in fp32 (1e-4 + 1e-3) and
     bf16 (`flash_err`'s bounds; its products on wgmma since PR 18),
     bitwise repeats, the `LSE` forward's output bitwise the other
     instance's, fused-projection views, a head-major view and an odd
     offset bitwise contiguous copies (the bf16 kernels' three load
     routes: TMA, 16-byte cp.async, element loads), autograd through
     flash against autograd of the plain version, the instances'
     resources (no bf16 instance spills), the HGMMA count of the bf16
     dK/dV and dQ kernels' SASS (> 0), and timed at FLASH_BWD_SHAPES
     beside SDPA's backward and the bound; (b) fp32 on the
     CPU against the card: `Model.loss` and every parameter's gradient of
     smollm-135m (full width, 2 layers), whisper-tiny (whole, 1500
     frames), paligemma-3b (full width, 2 layers) and the semanticbbv
     encoder (2 layers), per leaf within 1e-4 max(1, max|g|); (c)
     smollm-135m at full width and depth (bf16) trained by
     `repro_torch.launch.train`: 20 steps of 8 x 2048 tokens with AdamW
     and a checkpoint every 10 (build/chip_smoke_lm), exactly 30 flash
     forward and 30 backward launches a step, 3 profiled steps (device
     busy share), one step each under remat "full" and "dots"; (d) bf16
     steps of whisper-tiny (8 x (1500 frames + 448 tokens)) and
     paligemma-3b at 2 layers (4 x (256 patches + 768 tokens)); then,
     after the path's launches are read, the step-10 resume witness
     (bitwise; deterministic algorithms from (c) on);
 11. bf16 Stage 1 / Stage 2 (dtype "bfloat16"): (a) the bf16 instances of
     wkv, its backward and both set-attention kernels bit for bit the fp32
     instances on the upcast inputs (the serving and training shapes of
     phase 2, ragged N and M, N and M past one tile, dh 37, 40, 44 and
     128), against their plain versions at the JAX suite's bf16 bounds
     (plus one bf16 spacing where both sides round a bf16 output), each
     timed beside its fp32 instance, with its registers, spills and
     shared bytes (against the plans); (b) the default configs at bf16 on
     the CPU against the card: BBEs of 64 blocks, signatures of fp32 BBEs
     (fp32 activations on bf16 weights, within 1e-5) and of bf16 BBEs,
     Stage-1 and Stage-2 gradients per leaf, the card's fp32 evaluation
     of the same weights as the yardstick; (c) phase 4's serving path at
     bf16 (the BBE index fp32), each stage's wall time beside phase 4's,
     all 36 wkv launches the bf16 instance, Stage 2 on the fp32 one; (d)
     6 Stage-1 pre-training steps of 64 x 128 tokens at bf16, 12 wkv
     forward and 12 backward launches a step, all bf16, beside phase 5b's
     fp32 figures, then the step-3 resume, bitwise; (e) 3 Stage-2 steps of
     64 triplets on a bf16 BBE matrix, 9 set-attention forward and 9
     backward launches a step, all bf16.
 12. multi-device training and clustering, and the bf16 k-means: (a)
     the bf16 instances of both k-means kernels bit for bit the fp32
     instances on the upcast rows (JAX's bf16 case 256 x 16 with K 5, the
     build's shape 32,768 x 128 with K 14, ragged N, d 13 and 20: the
     element route), against their plain versions at JAX's bf16 bounds,
     timed beside the fp32 instances, with their registers, spills and
     shared bytes (against `kmeans_plan`); then one NCCL process group of
     one rank (a FileStore under build/chip_smoke_mesh) and a (1, 1)
     ("data", "model") mesh on the card: (b) `KnowledgeBase.build(k=14,
     mesh=)` on phase 4's store and `kmeans_device(mesh=)`: centroids,
     labels and representatives bitwise the unsharded build's, with its
     k-means launches; (c) 3 `Stage2Engine` steps of 64 triplets and 2
     Stage-1 pre-training steps of phase 5b's configuration under the
     mesh, bitwise the same steps without it (deterministic algorithms);
     (d) the Stage-2 checkpoint written under the mesh restored by an
     engine without one, bitwise; (e) `compress_tree` (int8 error
     feedback) on the card bitwise the CPU's on one step's gradients.
     Only the mesh runs count, on the "mesh" path; phase 12's seconds and
     the whole run's are printed.
The line before the last is the JSON kernel summary: `launches` counts
each kernel on its own path (serving; training for the set-attention
backward; Stage-1 training for the wkv backward; the zoo for flash; the
zoo's training for the flash backward), `launches_by_path` on each path
that launched it (serve, lifecycle, simpoint, train, stage1_training,
zoo, zoo_recurrent, zoo_moe, zoo_encdec, zoo_vlm, zoo_train, mesh); the
launches of comparisons and witness runs count on none. The records of
the two k-means kernels carry `bf16`, phase 12a's numbers of their bf16
instances (no path feeds them bf16 rows: the store is fp32). The records
of wkv, its backward and both set-attention kernels carry `bf16`, phase
11's numbers of their bf16 instances (ms beside the fp32 instance's,
bound, error, registers, spills, launches by path with the bf16
instance's among them: serve_bf16, stage1_training_bf16, stage2_bf16). wkv's entry also carries `zoo_shapes`, phase 7a's numbers at
the decode and prefill shapes, and flash's `moe_shape`, phase 8a's, and
`modal_shapes`, phase 9a's. The last line is {"ok": true, "device":
{...}}. Exits non-zero without CUDA.

    python3 chip_smoke.py --moe
    python3 chip_smoke.py --modal
    python3 chip_smoke.py --lm-train
    python3 chip_smoke.py --bf16
    python3 chip_smoke.py --mesh

run the setup and phase 8 alone, 6a's flash cases and phase 9, phase
10, phase 11 (after the world's generation; it then prints its own
JSON line, {"bf16": ...}, and takes fp32 steps itself for 11d's
comparison), or phase 12 (after the world and phase 4's serving path;
it prints its own JSON line, {"mesh": ...}), and

    python3 chip_smoke.py --profile-moe

profiles qwen3-moe's prefill of 8 x 2048 tokens and its decode step on 8
slots at full width and 2 layers (device time by kind, busy share).

    python3 chip_smoke.py --versus OTHER_CHECKOUT

runs none of that: it times wkv, the set-attention backward (SAB and
PMA shapes), the two k-means kernels (the build's shape), the bf16
flash kernel (smollm's and qwen3-moe's prefill shapes) and the bf16
flash backward (FLASH_BWD_SHAPES; device time through a CUDA graph and
back-to-back wrapper calls), and counts the shared loads, FMAs and
HGMMAs in their SASS (by the kernels' names before and since their
redesigns), of the port
under OTHER_CHECKOUT/src and of this one, in turns
(other, this, this, other), each in a process of its own, on one card:
a before/after comparison of two commits on the same card.

    python3 chip_smoke.py --profile-stage1

runs none of that either: it profiles 3 Stage-1 pre-training steps of
phase 5b's configuration (torch.profiler) and prints where a step's time
goes: host wall, kernels a step, the device's busy share, device time
by kind and the top kernels.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): memory rate, fp32
# outside the tensor cores (the rate of the work the Stage-1/2 kernels do,
# all in fp32) and bf16 on the tensor cores (the least time of the zoo's
# bf16 attention, whatever units a kernel uses).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12

SEED = 0
N_INTERVALS = 1000        # per program, the paper's count
TRAIN_STEPS = 20          # phase 5, with a checkpoint every 10 steps
TRAIN_BATCH = 64          # triplets a step: 3 x 64 interval sets
STAGE1_STEPS = 20         # phase 5b pre-training, a checkpoint every 10
STAGE1_BATCH = 64         # token rows (x 128) a pre-training step
TRIPLET_STEPS = 10        # phase 5b triplet fine-tuning
TRIPLET_BATCH = 32        # triplets a step: 3 x 32 token rows
ZOO_ARCH = "smollm_135m"  # phase 6: the zoo model the repo's serve demo runs
PREFILL_BATCH, PREFILL_LEN = 8, 2048
SERVE_REQUESTS, SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_MAX_NEW = 24, 8, 1024, 64
# (B, S, T, H, K, D, causal, window, prefix_len, fp32); the first timed.
# The prefix cases cut a 64-key tile (100), a 128-row query tile with a
# window (200), or lie past T (1024)
FLASH_CASES = [
    (4, 2048, 2048, 9, 3, 64, True, 0, 0, False),     # smollm's prefill
    (1, 4096, 4096, 32, 8, 128, True, 0, 0, False),   # qwen3-4b's heads
    (2, 2048, 2048, 9, 3, 64, True, 512, 0, False),   # a window of 512
    (2, 448, 1500, 6, 6, 64, False, 0, 0, False),     # whisper's cross shape
    (2, 512, 512, 8, 1, 256, False, 0, 0, False),     # paligemma's heads
    (2, 1000, 1000, 9, 3, 64, True, 0, 0, True),      # ragged tile, fp32
    (2, 1000, 1000, 8, 2, 80, True, 0, 0, False),     # D 80: padded to 128
    (2, 1000, 1000, 8, 1, 256, True, 0, 100, False),
    (1, 600, 600, 8, 1, 256, True, 0, 100, True),
    (2, 1000, 1000, 8, 1, 256, True, 128, 200, False),
    (1, 600, 600, 8, 1, 256, True, 128, 200, True),
    (1, 700, 700, 8, 2, 64, True, 0, 1024, False),
    (1, 700, 700, 8, 2, 64, True, 0, 1024, True),
]
FLASH_VIEW_SHAPE = (4, 1024, 9, 3, 64)   # (B, S, H, K, D) of the views
ENCODER_ARCH, XLSTM_ARCH = "semanticbbv_encoder", "xlstm_1_3b"   # phase 7
WKV_DECODE_SHAPE = (8, 1, 6, 64)       # (B, S, H, dh): the encoder, 8 slots
WKV_PREFILL_SHAPE = (8, 2048, 6, 64)   # its prefill of 8 x 2048 tokens
RNN_PREFILL = {ENCODER_ARCH: (8, 2048), XLSTM_ARCH: (4, 2048)}
# requests, prompt tokens (least, most), new tokens each, slots, max_seq
RNN_SERVE = {ENCODER_ARCH: (24, 16, 256, 64, 8, 1024),
             XLSTM_ARCH: (16, 16, 128, 32, 8, 512)}
MAMBA_WIDTH = (8192, 16, 4)            # jamba-1.5-large: d_model, state, conv
MOE_ARCH, GROK_ARCH = "qwen3_moe_235b_a22b", "grok_1_314b"   # phase 8
MOE_LAYERS = 8            # of qwen3-moe's 94: 42.3 GB of bf16 on one card
MOE_PARAMS = 21_146_703_872                 # its parameters at 8 layers
MOE_FLASH_SHAPE = (8, 2048, 64, 4, 128)     # (B, S, H, K, D): its prefill
MOE_PREFILL = (8, 2048)
# requests, prompt tokens (least, most), new tokens each, slots, max_seq
MOE_SERVE = (16, 16, 128, 32, 8, 512)
MOE_CHECK_TOKENS = (2, 64)   # 8b: a prefill of 2 x 64, then 4 decode steps
MOE_PROFILE_LAYERS = 2       # --profile-moe
WHISPER_ARCH, PALI_ARCH = "whisper_tiny", "paligemma_3b"    # phase 9
# 9a: timed at the four shapes the modal archs' prefills give flash:
# (name, (B, S, T, H, K, D), causal, prefix_len)
FLASH_MODAL_SHAPES = [
    ("whisper encoder self", (16, 1500, 1500, 6, 6, 64), False, 0),
    ("whisper cross", (16, 448, 1500, 6, 6, 64), False, 0),
    ("whisper decoder self", (16, 448, 448, 6, 6, 64), True, 0),
    ("paligemma prefill", (8, 2048, 2048, 8, 1, 256), True, 256),
]
# 9c: whisper's 30 s window (1500 frames) and 448-token text context
WHISPER_PREFILL = (16, 1500, 448)          # B, frames, tokens
WHISPER_CHECK = (2, 1500, 64)              # 9b, fp32 CPU vs card
# requests, prompt tokens (least, most), new tokens each, slots, max_seq
WHISPER_SERVE = (16, 4, 128, 128, 8, 448)
PALI_PREFILL = (8, 256, 1792)              # B, patches, tokens: 2,048 rows
PALI_CHECK = (2, 256, 64)                  # 9b, fp32 CPU vs card
PALI_CHECK_LAYERS = 2                      # of 18, for the CPU half
PALI_SERVE = (16, 16, 128, 32, 8, 512)
WHISPER_PARAMS, PALI_PARAMS = 36_464_256, 2_508_662_784
# phase 10: smollm-135m trained at full width and depth (bf16), 8 x 2048
# tokens a step; 10a times the flash backward at the training shapes of
# smollm and the modal archs: (name, (B, S, T, H, K, D), causal, prefix)
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ = 20, 8, 2048
LM_TRAIN_PARAMS = 134_515_008
FLASH_BWD_SHAPES = [
    ("smollm train", (8, 2048, 2048, 9, 3, 64), True, 0),
    ("whisper encoder", (16, 1500, 1500, 6, 6, 64), False, 0),
    ("whisper cross", (16, 448, 1500, 6, 6, 64), False, 0),
    ("paligemma prefix", (8, 2048, 2048, 8, 1, 256), True, 256),
]
# 10a: autograd through flash against autograd of the plain version at
# (B, S, T, H, K, D, causal, prefix_len); in bf16 to a relative L2 error
# and a max abs error of this times max(1, max|g|) (the kernel rounds P
# before P V and takes delta from the stored o; on the H100 these shapes
# gave 4e-5 to 1.5e-3 and 0.0005-0.0156 at max|g| 0.29-7.3)
FLASH_AUTOGRAD_SHAPES = [(2, 1024, 1024, 9, 3, 64, True, 0),
                         (2, 448, 1500, 6, 6, 64, False, 0),
                         (2, 1024, 1024, 8, 1, 256, True, 256)]
FLASH_AUTOGRAD_BF16_REL = 1e-2
# 10b: (arch, layers (0: all), B, S, extra input) fp32 CPU vs card
LM_TRAIN_CHECKS = [("smollm_135m", 2, 2, 128, None),
                   ("whisper_tiny", 0, 2, 64, "frames"),
                   ("paligemma_3b", 2, 2, 64, "patches"),
                   ("semanticbbv_encoder", 2, 2, 128, None)]
# 10d: bf16 steps of whisper-tiny (B, frames, tokens) and paligemma-3b
# at 2 layers (B, patches, tokens)
LM_MASK_STEPS = 3
WHISPER_TRAIN = (8, 1500, 448)
PALI_TRAIN = (4, 256, 768)
PALI_TRAIN_LAYERS = 2
# 8b: the card may route a token otherwise than the CPU only where two of
# the CPU's top k+1 probabilities lie within this many fp32 ulps
ROUTING_ULPS = 8
# SASS opcodes counted in the register-tiled kernels: 4- and 16-byte
# shared loads against the FMAs they feed
SASS_OPS = ("LDS", "LDS.128", "FFMA", "FMUL", "SHFL*")
# phase 11 (bf16 Stage 1 / Stage 2):
# The JAX suite's bf16 bounds of each kernel against its plain version
# (atol, rtol; tests/test_kernels.py: wkv :48, set attention :145, its
# gradients :247)
BF16_KERNEL_BOUNDS = {"wkv": (5e-2, 1e-3), "wkv_backward": (5e-2, 1e-3),
                      "set_attention": (3e-2, 1e-3),
                      "set_attention_backward": (5e-2, 1e-3)}
# a bf16 output of a kernel and of its plain version each round their fp32
# value once, so where the two fp32 values straddle a rounding boundary
# they differ by one bf16 spacing, at most 2^-7 of the value: added to the
# rtol of those comparisons (the suite's own cases are small enough that
# its atol covers it; Stage-1 training's gradients are not)
BF16_SPACING = 2.0 ** -7
# 11b: the full-width bf16 models CPU vs card stage by stage (the
# embedding, each block or MAB, the head), each stage given the CPU's input
# and, backwards, the CPU's cotangent: its output within BF16_MODULE_REL
# (relative L2: 2^-9, half of bf16's unit roundoff; the two devices round
# the same values but where their fp32 sums differ in the last place, and
# one flip of an L2 norm's rounding moves its whole row), its gradients
# per leaf within BF16_GRAD_REL and their median leaf within
# BF16_MEDIAN_REL (the CPU tests' bounds against JAX). The card's fp32
# evaluation of the same stages, rounded to bf16, must fail them. (End to
# end, 12 bf16 layers carry the devices' summation orders as far as the
# rounding itself: printed, not bounded.)
BF16_MODULE_REL = 2.0 ** -9
BF16_GRAD_REL = 2e-2
BF16_MEDIAN_REL = 1e-2
BF16_BLOCKS = 64          # 11b: blocks encoded on both devices
BF16_STAGE1_STEPS = 6     # 11d: pre-training steps, a checkpoint every 3
BF16_STAGE2_STEPS = 3     # 11e: Stage-2 steps on a bf16 BBE matrix
# what phases 4 and 5b measured in fp32 in this process, printed beside
# phase 11's figures (absent when phase 11 runs alone)
FP32_FIGURES = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA
    events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one fn() call without the host's: `calls` calls
    captured in one CUDA graph, replayed `reps` times after a warm-up
    replay (CUDA events around the replays)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * calls)
    del graph
    return ms


def kernel_ms(fn, reps: int):
    """(device ms, wrapper ms) of a kernel wrapper's call: its device time
    (`device_ms`), and the mean of `reps` back-to-back calls from the host
    (`cuda_ms`), which also counts the wrapper's host work when that is
    the longer."""
    return device_ms(fn), cuda_ms(fn, reps)


def bound(nbytes: float, flops: float, peak: float = PEAK_FP32_FLOP_PER_S,
          flops_bf16: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over their peaks: `flops` over `peak` (fp32 unless given)
    plus `flops_bf16`, products of bf16 operands, over the bf16 peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / peak + flops_bf16 / PEAK_BF16_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_err(got, want, atol: float, rtol: float, what: str) -> float:
    """Max |got - want|; fails unless |got - want| <= atol + rtol |want|
    everywhere (numpy's allclose rule)."""
    diff = (got - want).abs()
    require(bool((diff <= atol + rtol * want.abs()).all()),
            f"{what}: max abs err {diff.max().item():.3g} beyond atol "
            f"{atol} rtol {rtol}")
    return diff.max().item()


def describe(a: dict) -> str:
    return (f"{a['registers']} registers a thread, shared "
            f"{a['static_smem']} B static + {a['dynamic_smem']} B dynamic a "
            f"block, {a['local_bytes']} B local (spills) a thread")


@functools.lru_cache(maxsize=None)
def _sass(lib_path: str):
    """The SASS of a library (`cuobjdump -sass`, once a process), or None
    where the toolkit has no cuobjdump."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def sass_counts(lib_path: str, function, ops=("HGMMA*",)):
    """Counts of the given opcodes in the SASS of the kernels whose name
    holds `function` (a string, or a tuple of strings that must all be
    in the name), or None where the toolkit has no cuobjdump. An op
    matches exactly ("LDS" is the 4-byte shared load, "LDS.128" the
    16-byte one), or by prefix when it ends in "*"; never-executed `@!PT`
    placeholders are skipped."""
    sass = _sass(lib_path)
    if sass is None:
        return None
    names = (function,) if isinstance(function, str) else function
    counts, inside = dict.fromkeys(ops, 0), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = all(f in line for f in names)
        elif inside and "@!PT" not in line:
            fields = line.split("*/")
            words = fields[1].split() if len(fields) > 1 else []
            if words and words[0].startswith("@"):   # a predicate
                words = words[1:]
            op = words[0] if words else ""
            for key in counts:
                if op == key or (key.endswith("*")
                                 and op.startswith(key[:-1])):
                    counts[key] += 1
    return counts


# ---------------------------------------------------------------- phase 2

def check_wkv(dev, gen):
    from repro_torch.kernels.wkv import wkv, wkv_reference

    def inputs(B, S, H, dh, with_state=False):
        r, k, v = (torch.randn((B, S, H, dh), generator=gen, device=dev)
                   for _ in range(3))
        k = k / k.norm(dim=-1, keepdim=True).clamp(min=1e-6)
        w = 0.7 + 0.3 * torch.rand((B, S, H, dh), generator=gen, device=dev)
        beta = torch.rand((B, S, H), generator=gen, device=dev)
        s0 = (0.1 * torch.randn((B, H, dh, dh), generator=gen, device=dev)
              if with_state else None)
        return r, k, v, w, beta, s0

    err = 0.0
    # (B, S, H, dh): the encoder's shape, then dh 44 / 16 / 8 and odd S;
    # dh 128 (the third kernel instance), S 1, 129 and 200 (partial stages)
    for B, S, H, dh, st in [(256, 128, 6, 64, False), (3, 37, 2, 44, True),
                            (2, 64, 3, 16, True), (1, 5, 1, 8, False),
                            (2, 129, 2, 128, True), (2, 1, 3, 64, True),
                            (3, 200, 2, 64, True), (2, 129, 2, 44, False)]:
        args = inputs(B, S, H, dh, st)
        y, sf = wkv(*args)
        y_ref, sf_ref = wkv_reference(*args)
        # the JAX suite's wkv tolerance: sums over dh run in another order
        err = max(err, max_err(y, y_ref, 1e-4, 1e-3, f"wkv y {B, S, H, dh}"),
                  max_err(sf, sf_ref, 1e-4, 1e-3, f"wkv state {B, S, H, dh}"))
    # state chaining: two halves with the state carried == one pass
    args = inputs(2, 64, 2, 44)
    y_full, s_full = wkv(*args)
    r, k, v, w, beta, _ = args
    h = 32
    y1, s1 = wkv(*(a[:, :h].contiguous() for a in (r, k, v, w, beta)))
    y2, s2 = wkv(*(a[:, h:].contiguous() for a in (r, k, v, w, beta)),
                 state=s1)
    max_err(torch.cat([y1, y2], 1), y_full, 1e-4, 1e-3, "wkv chained y")
    max_err(s2, s_full, 1e-4, 1e-3, "wkv chained state")

    from repro_torch.kernels import _lib
    from repro_torch.kernels.wkv.ops import kernel_plan
    attrs = {}
    for d in (32, 64, 128):
        attrs[d] = a = _lib.kernel_attributes("rt_wkv_attributes", 0, d)
        log(f"  wkv kernel, dh <= {d}: {describe(a)}")
        require(a["static_smem"] == kernel_plan(d)["shared_bytes"],
                f"wkv dh {d}: shared bytes differ from kernel_plan's")
    # the serving instances (no states; "Lb0E": the template's false)
    sass = sass_counts(str(_lib.build_library()),
                       ("wkv_forward_kernel", "Lb0E"), SASS_OPS)
    log(f"  wkv SASS (3 serving instances): {sass}")

    B, S, H, dh = 256, 128, 6, 64
    args = inputs(B, S, H, dh)
    ms, wrapper_ms = kernel_ms(lambda: wkv(*args), reps=20)
    plain_ms = cuda_ms(lambda: wkv_reference(*args), reps=3, warmup=1)
    n_seq = 4 * B * S * H * dh + B * S * H            # r k v w, beta
    nbytes = 4 * (n_seq + B * S * H * dh + B * H * dh * dh)   # + y, S_f
    flops = 7 * B * H * S * dh * dh
    return dict(err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                library_ms=None,
                bound=bound(nbytes, flops),
                shape=f"B={B} S={S} H={H} dh={dh}",
                extra=dict(registers=attrs[64]["registers"],
                           local_bytes=attrs[64]["local_bytes"], sass=sass))


def check_wkv_backward(dev, gen):
    """The wkv backward kernel against the plain reverse loop, with an
    initial state and a final-state gradient: Stage-1 training's shape
    (B 64, S 128, H 6, dh 64), dh 16, 48 and 128, S 1 and 13. The forward
    that writes the states gives y and the final state bitwise equal to
    the serving forward; two backward launches give the same bits."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.wkv import (
        wkv, wkv_backward, wkv_backward_reference,
    )
    from repro_torch.kernels.wkv.ops import _forward, backward_plan

    def inputs(B, S, H, dh):
        r, k, v, dy = (torch.randn((B, S, H, dh), generator=gen, device=dev)
                       for _ in range(4))
        k = k / k.norm(dim=-1, keepdim=True).clamp(min=1e-6)
        w = 0.7 + 0.3 * torch.rand((B, S, H, dh), generator=gen, device=dev)
        beta = torch.rand((B, S, H), generator=gen, device=dev)
        s0, dsf = (torch.randn((B, H, dh, dh), generator=gen, device=dev)
                   for _ in range(2))
        return r, k, v, w, beta, 0.1 * s0, dy, dsf

    err = 0.0
    for shape in [(64, 128, 6, 64), (2, 13, 2, 16), (2, 13, 3, 48),
                  (2, 9, 2, 128), (2, 1, 3, 64), (3, 1, 2, 48),
                  (2, 37, 2, 7)]:
        r, k, v, w, beta, s0, dy, dsf = inputs(*shape)
        y, sf, states = _forward(r, k, v, w, beta, s0, save=True)
        y_serve, sf_serve = wkv(r, k, v, w, beta, s0)
        require(torch.equal(y, y_serve) and torch.equal(sf, sf_serve),
                f"wkv {shape}: the forward with states is not bitwise the "
                "serving forward")
        out = wkv_backward(r, k, v, w, beta, s0, states, dy, dsf)
        ref = wkv_backward_reference(r, k, v, w, beta, s0, dy, dsf)
        for name, a, b in zip(("dr", "dk", "dv", "dw", "dbeta", "dstate"),
                              out, ref):
            require(bool(torch.isfinite(a).all()),
                    f"wkv_backward {shape}: non-finite {name}")
            err = max(err, max_err(a, b, 1e-4, 1e-3,
                                   f"wkv_backward {name} {shape}"))
        again = wkv_backward(r, k, v, w, beta, s0, states, dy, dsf)
        require(all(torch.equal(a, b) for a, b in zip(out, again)),
                f"wkv_backward {shape}: two runs are not bitwise equal")

    attrs = {}
    for d in (32, 64, 128):
        attrs[d] = a = _lib.kernel_attributes("rt_wkv_backward_attributes", 0,
                                                 d)
        log(f"  wkv_backward kernel, dh <= {d}: {describe(a)}")
        require(a["dynamic_smem"] == backward_plan(d)["shared_bytes"],
                f"wkv_backward dh {d}: shared bytes differ from "
                "backward_plan's")
        require(a["local_bytes"] == 0, f"wkv_backward dh {d}: spills")
    sass = sass_counts(str(_lib.build_library()), "wkv_backward_kernel",
                       SASS_OPS)
    log(f"  wkv_backward SASS (3 instances): {sass}")

    B, S, H, dh = 64, 128, 6, 64
    r, k, v, w, beta, _, dy, dsf = inputs(B, S, H, dh)
    _, _, states = _forward(r, k, v, w, beta, None, save=True)
    args = (r, k, v, w, beta, None, states, dy, dsf)
    ms, wrapper_ms = kernel_ms(lambda: wkv_backward(*args), reps=20)
    plain_ms = cuda_ms(lambda: wkv_backward_reference(
        r, k, v, w, beta, None, dy, dsf), reps=3, warmup=1)
    fwd_states_ms = device_ms(lambda: _forward(r, k, v, w, beta, None,
                                               save=True))
    fwd_ms = device_ms(lambda: _forward(r, k, v, w, beta, None, save=False))
    log(f"  wkv forward at this shape: ms {fwd_ms:.4f}; writing the states "
        f"(0.81 GB) ms {fwd_states_ms:.4f}")
    # reads r k v w dy, beta, the states and dsf once; writes dr dk dv dw,
    # dbeta and dS_0; 22 dh^2 operations a token and head (A formed in both
    # passes)
    n_tok = B * S * H * dh
    nbytes = 4 * (5 * n_tok + B * S * H + B * S * H * dh * dh
                  + B * H * dh * dh + 4 * n_tok + B * S * H + B * H * dh * dh)
    flops = 22 * B * S * H * dh * dh
    return dict(err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                library_ms=None, bound=bound(nbytes, flops),
                shape=f"B={B} S={S} H={H} dh={dh}",
                extra=dict(forward_ms=fwd_ms, forward_states_ms=fwd_states_ms,
                           registers=attrs[64]["registers"],
                           local_bytes=attrs[64]["local_bytes"],
                           registers_dh32=attrs[32]["registers"],
                           registers_dh128=attrs[128]["registers"],
                           sass=sass))


def check_set_attention(dev, gen):
    import torch.nn.functional as F
    from repro_torch.kernels.set_attention import (
        NEG_INF, masked_set_attention, set_attention_reference,
    )

    def inputs(B, H, N, M, dh, weighted=True, masked=True, empty_rows=0):
        q = torch.randn((B, H, N, dh), generator=gen, device=dev)
        k = torch.randn((B, H, M, dh), generator=gen, device=dev)
        v = torch.randn((B, H, M, dh), generator=gen, device=dev)
        bias = (torch.rand((B, M), generator=gen, device=dev)
                if weighted else None)
        mask = None
        if masked:
            mask = torch.rand((B, M), generator=gen, device=dev) < 0.45
            mask[:, 0] = True
            mask[B - empty_rows:] = False        # fully masked rows
        return q, k, v, bias, mask

    err = 0.0
    # SAB and PMA at the main path's shapes (padded batch rows fully
    # masked), then M 13, dh 44, N 1, no bias, no mask
    for case in [(512, 4, 64, 64, 64, True, True, 24),
                 (512, 4, 1, 64, 64, True, True, 24),
                 (2, 2, 5, 13, 16, True, True, 1),
                 (3, 2, 7, 13, 44, True, True, 0),
                 (2, 3, 1, 33, 44, False, True, 1),
                 (2, 2, 7, 130, 16, True, False, 0)]:
        args = inputs(*case)
        o = masked_set_attention(*args)
        o_ref = set_attention_reference(*args)
        require(bool(torch.isfinite(o).all()), f"set_attention {case}: "
                "non-finite output")
        # fp32 throughout, sums in another order: 1e-5 absolute
        err = max(err, max_err(o, o_ref, 1e-5, 0.0, f"set_attention {case}"))

    # the PMA (one seed query): its own kernel, timed beside the SAB's
    pma = inputs(512, 4, 1, 64, 64, True, True, 24)
    pma_ms, pma_wrapper_ms = kernel_ms(lambda: masked_set_attention(*pma),
                                       reps=50)
    pma_plain_ms = cuda_ms(lambda: set_attention_reference(*pma), reps=20)
    pma_bound = bound(4 * (2 * 512 * 4 * 64 + 2 * 512 * 4 * 64 * 64
                           + 512 * 64) + 512 * 64,
                      512 * 4 * (4 * 64 * 64 + 5 * 64))
    log(f"  set_attention PMA [B=512 H=4 N=1 M=64 dh=64]: ms {pma_ms:.4f} "
        f"(wrapper {pma_wrapper_ms:.4f}), "
        f"plain_ms {pma_plain_ms:.4f}, bound_ms {pma_bound[0]:.4f} "
        f"({pma_bound[1]})")
    from repro_torch.kernels import _lib
    attrs = {}
    for what, shape in (("SAB", (64, 64, 64)), ("PMA", (1, 64, 64))):
        attrs[what] = a = _lib.kernel_attributes(
            "rt_set_attention_forward_attributes", 0, *shape)
        log(f"  set_attention {what} kernel: {describe(a)}")

    B, H, N, M, dh = 512, 4, 64, 64, 64
    q, k, v, bias, mask = inputs(B, H, N, M, dh, True, True, 24)
    ms, wrapper_ms = kernel_ms(
        lambda: masked_set_attention(q, k, v, bias, mask), reps=50)
    plain_ms = cuda_ms(lambda: set_attention_reference(q, k, v, bias, mask),
                       reps=20)
    attn_mask = (bias + torch.where(mask, 0.0, NEG_INF))[:, None, None, :]
    o_lib = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
    e_lib = (o_lib - masked_set_attention(q, k, v, bias, mask)).abs().max()
    log(f"  set_attention vs scaled_dot_product_attention: max abs diff "
        f"{e_lib.item():.3g} (yardstick only)")
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask), reps=50)
    nbytes = 4 * (2 * B * H * N * dh + 2 * B * H * M * dh + B * M) + B * M
    flops = B * H * (4 * N * M * dh + 5 * N * M)
    return dict(err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                library_ms=library_ms,
                bound=bound(nbytes, flops),
                shape=f"B={B} H={H} N={N} M={M} dh={dh}",
                extra=dict(pma_ms=pma_ms, pma_wrapper_ms=pma_wrapper_ms,
                           pma_plain_ms=pma_plain_ms,
                           pma_bound_ms=pma_bound[0],
                           registers=attrs["SAB"]["registers"],
                           local_bytes=attrs["SAB"]["local_bytes"],
                           pma_registers=attrs["PMA"]["registers"],
                           pma_local_bytes=attrs["PMA"]["local_bytes"]))


def check_set_attention_backward(dev, gen):
    import torch.nn.functional as F
    from repro_torch.kernels.set_attention import (
        NEG_INF, set_attention_backward, set_attention_backward_reference,
    )

    def inputs(B, H, N, M, dh, weighted=True, masked=True, empty_rows=0):
        q = torch.randn((B, H, N, dh), generator=gen, device=dev)
        k = torch.randn((B, H, M, dh), generator=gen, device=dev)
        v = torch.randn((B, H, M, dh), generator=gen, device=dev)
        do = torch.randn((B, H, N, dh), generator=gen, device=dev)
        bias = (torch.rand((B, M), generator=gen, device=dev)
                if weighted else None)
        mask = None
        if masked:
            mask = torch.rand((B, M), generator=gen, device=dev) < 0.45
            mask[:, 0] = True
            mask[B - empty_rows:] = False        # fully masked rows
        return q, k, v, bias, mask, do

    err = 0.0
    # Stage-2 training's SAB and PMA (64 sets of one role), then M 13,
    # dh 44, N 1, no bias, no mask; masks with holes, empty rows; then the
    # routes' edges: N 4 (last of the PMA kernel) and 5, N and M 65 and
    # 130 (several tiles, running max over key tiles), dh 8, 44 and 128
    # (two head-dim chunks), and a PMA whose k rows span several chunks
    for case in [(64, 4, 64, 64, 64, True, True, 2),
                 (64, 4, 1, 64, 64, True, True, 2),
                 (2, 2, 5, 13, 16, True, True, 1),
                 (3, 2, 7, 13, 44, True, True, 1),
                 (2, 3, 1, 33, 44, False, True, 1),
                 (2, 2, 7, 130, 16, True, False, 0),
                 (3, 2, 4, 64, 64, True, True, 1),
                 (3, 2, 5, 64, 64, True, True, 1),
                 (2, 2, 65, 65, 64, True, True, 1),
                 (2, 2, 130, 130, 44, True, True, 1),
                 (2, 2, 9, 21, 8, True, True, 1),
                 (2, 2, 70, 13, 128, True, True, 1),
                 (2, 2, 3, 130, 128, False, True, 1),
                 (2, 2, 1, 300, 44, True, True, 1)]:
        q, k, v, bias, mask, do = inputs(*case)
        out = set_attention_backward(q, k, v, bias, mask, do)
        ref = set_attention_backward_reference(q, k, v, bias, mask, do)
        for name, a, b in zip(("dq", "dk", "dv", "db"), out, ref):
            require(bool(torch.isfinite(a).all()),
                    f"set_attention_backward {case}: non-finite {name}")
            # the JAX suite's gradient bound (tests/test_kernels.py:247)
            err = max(err, max_err(a, b, 1e-4, 1e-3,
                                   f"set_attention_backward {name} {case}"))
        if mask is not None:
            # masked keys of rows with any valid key: exactly zero
            dead = ~mask & mask.any(dim=1, keepdim=True)
            for name, g in (("dk", out[1].permute(0, 2, 1, 3)),
                            ("dv", out[2].permute(0, 2, 1, 3)),
                            ("db", out[3].permute(0, 2, 1))):
                require(bool((g[dead] == 0).all()),
                        f"set_attention_backward {case}: {name} of a masked "
                        "key is not exactly 0")
        again = set_attention_backward(q, k, v, bias, mask, do)
        require(all(torch.equal(a, b) for a, b in zip(out, again)),
                f"set_attention_backward {case}: two runs are not bitwise "
                "equal")

    def cost(B, H, N, M, dh):
        """(bytes, flops) the backward must move and do."""
        n_in = 2 * B * H * N * dh + 2 * B * H * M * dh          # q, dO, k, v
        n_out = B * H * N * dh + 2 * B * H * M * dh + B * H * M  # dq dk dv db
        return (4 * (n_in + n_out + B * M) + B * M,             # + bias, mask
                B * H * (10 * N * M * dh + 12 * N * M))  # products + softmax

    # resources of both routes, against backward_plan's shared bytes, and
    # the shared loads and FMAs of their SASS
    from repro_torch.kernels import _lib
    from repro_torch.kernels.set_attention.ops import backward_plan
    attrs = {}
    for what, shape in (("SAB", (64, 64, 64)), ("PMA", (1, 64, 64))):
        attrs[what] = a = _lib.kernel_attributes(
            "rt_set_attention_backward_attributes", 0, *shape)
        log(f"  set_attention_backward {what} kernel "
            f"({backward_plan(*shape)['route']}): {describe(a)}")
        require(a["dynamic_smem"] == backward_plan(*shape)["shared_bytes"],
                f"set_attention_backward {what}: shared bytes differ from "
                "backward_plan's")
    sass = {}
    for what, fn in (("SAB", "bwd12tiled_kernel"),
                     ("PMA", "bwd14small_n_kernel")):
        sass[what] = sass_counts(str(_lib.build_library()), fn, SASS_OPS)
        log(f"  set_attention_backward {what} SASS: {sass[what]}")

    # the PMA (one seed query): its own kernel, timed against its own bound
    pma_shape = (64, 4, 1, 64, 64)
    pma = inputs(*pma_shape, True, True, 2)
    pma_ms, pma_wrapper_ms = kernel_ms(lambda: set_attention_backward(*pma),
                                       reps=100)
    pma_plain_ms = cuda_ms(lambda: set_attention_backward_reference(*pma),
                           reps=20)
    pma_bound = bound(*cost(*pma_shape))
    log(f"  set_attention_backward PMA [B=64 H=4 N=1 M=64 dh=64]: ms "
        f"{pma_ms:.4f} (wrapper {pma_wrapper_ms:.4f}), plain_ms "
        f"{pma_plain_ms:.4f}, bound_ms "
        f"{pma_bound[0]:.4f} ({pma_bound[1]})")

    B, H, N, M, dh = 64, 4, 64, 64, 64
    q, k, v, bias, mask, do = inputs(B, H, N, M, dh, True, True, 2)
    ms, wrapper_ms = kernel_ms(
        lambda: set_attention_backward(q, k, v, bias, mask, do), reps=100)
    plain_ms = cuda_ms(lambda: set_attention_backward_reference(
        q, k, v, bias, mask, do), reps=20)
    # yardstick: the backward of scaled_dot_product_attention with the same
    # float mask (q, k, v gradients; the bias gradient is not asked for)
    attn_mask = (bias + torch.where(mask, 0.0, NEG_INF))[:, None, None, :]
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    library_ms = None
    try:
        o_lib = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=attn_mask)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            o_lib, (ql, kl, vl), do, retain_graph=True), reps=50)
    except RuntimeError as e:       # no SDPA backend takes this: print null
        log(f"  scaled_dot_product_attention backward unavailable: {e}")
    return dict(err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                library_ms=library_ms,
                bound=bound(*cost(B, H, N, M, dh)),
                shape=f"B={B} H={H} N={N} M={M} dh={dh}",
                extra=dict(pma_ms=pma_ms, pma_wrapper_ms=pma_wrapper_ms,
                           pma_plain_ms=pma_plain_ms,
                           pma_bound_ms=pma_bound[0],
                           registers=attrs["SAB"]["registers"],
                           local_bytes=attrs["SAB"]["local_bytes"],
                           pma_registers=attrs["PMA"]["registers"],
                           pma_local_bytes=attrs["PMA"]["local_bytes"],
                           sass=sass))


def _clustered(n, d, k, gen, dev, spread=0.05):
    """Unit-norm rows around k random centres (nearest centre unambiguous),
    and centroids near those centres."""
    centres = torch.randn((k, d), generator=gen, device=dev)
    centres = centres / centres.norm(dim=-1, keepdim=True)
    idx = torch.randint(k, (n,), generator=gen, device=dev)
    x = centres[idx] + spread * torch.randn((n, d), generator=gen, device=dev)
    x = x / x.norm(dim=-1, keepdim=True)
    c = centres + 0.01 * torch.randn((k, d), generator=gen, device=dev)
    return x.contiguous(), c.contiguous()


def kmeans_resources(name: str, d: int = 128, k: int = 14) -> dict:
    """Registers, shared bytes and spills of the k-means kernel `name`
    ("assign" or "update") at (d, k), its shared bytes held to
    `kmeans_plan`'s."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.kmeans_assign.ops import kmeans_plan
    a = _lib.kernel_attributes(f"rt_kmeans_{name}_attributes", 0, d, k)
    log(f"  kmeans_{name} kernel (d={d} K={k}): {describe(a)}")
    require(a["static_smem"] + a["dynamic_smem"]
            == kmeans_plan(1, d, k)["shared_bytes"],
            f"kmeans_{name}: shared bytes differ from kmeans_plan's")
    return a


def check_kmeans_assign(dev, gen):
    from repro_torch.kernels.kmeans_assign import (
        kmeans_assign, kmeans_assign_reference,
    )
    err = 0.0
    # store capacity x 128 (clustered and uniform), the compacted store's
    # capacity (4b's re-pin and rebuild), then odd sizes: K 30 at d 200
    # (two K tiles), d 7 (element loads), SimPoint's d 15 and K 10
    for n, d, k, clustered in [(32768, 128, 14, True), (32768, 128, 14, False),
                               (16384, 128, 14, True),
                               (1000, 64, 14, False), (513, 32, 30, False),
                               (100, 8, 4, False), (77, 200, 5, False),
                               (77, 200, 30, True), (300, 7, 9, False),
                               (1000, 15, 10, True), (1000, 15, 10, False)]:
        if clustered:
            x, c = _clustered(n, d, k, gen, dev)
        else:
            x = torch.randn((n, d), generator=gen, device=dev)
            c = torch.randn((k, d), generator=gen, device=dev)
        a, d2 = kmeans_assign(x, c)
        a_ref, d2_ref = kmeans_assign_reference(x, c)
        full = (x * x).sum(-1, keepdim=True) - 2.0 * (x @ c.T) + \
            (c * c).sum(-1)[None, :]
        two = torch.topk(full, 2, dim=-1, largest=False).values
        decisive = (two[:, 1] - two[:, 0]) > 1e-5
        differ = a.long() != a_ref.long()
        require(not bool((differ & decisive).any()),
                f"kmeans_assign {n, d, k}: labels differ on decisive rows")
        gap = full.gather(1, a.long()[:, None])[:, 0] - two[:, 0]
        require(bool((gap[differ] <= 1e-5).all()),
                f"kmeans_assign {n, d, k}: a differing label is no tie")
        err = max(err, max_err(d2, d2_ref, 1e-3, 0.0,
                               f"kmeans_assign d2 {n, d, k}"))
    attrs = kmeans_resources("assign")
    n, d, k = 32768, 128, 14
    x, c = _clustered(n, d, k, gen, dev)
    ms, wrapper_ms = kernel_ms(lambda: kmeans_assign(x, c), reps=100)
    plain_ms = cuda_ms(lambda: kmeans_assign_reference(x, c), reps=100)
    nbytes = 4 * (n * d + k * d) + 8 * n
    flops = n * (2 * k * d + 2 * d + 3 * k)
    return dict(err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                library_ms=None,
                bound=bound(nbytes, flops), shape=f"N={n} d={d} K={k}",
                extra=dict(registers=attrs["registers"],
                           local_bytes=attrs["local_bytes"]))


def check_kmeans_update(dev, gen, n_valid_main: int):
    from repro_torch.kernels.kmeans_assign import (
        kmeans_update, kmeans_update_reference,
    )
    err = 0.0
    # mask: "holes", None (every row weighs 1) or the count of live rows
    # in a prefix. The build's shape (a prefix) and a mask with holes, the
    # compacted store's rebuild (16,000 of 16,384 rows live), then odd
    # sizes: K 30 at d 200 and N 77 with a prefix, d 7 (element loads),
    # SimPoint's d 15 and K 10 with no mask
    for n, d, k, mask in [(32768, 128, 14, 24576),
                          (32768, 128, 14, "holes"), (16384, 128, 14, 16000),
                          (1000, 64, 14, "holes"), (513, 32, 30, 384),
                          (100, 8, 4, "holes"), (77, 200, 30, 57),
                          (300, 7, 9, "holes"), (1000, 15, 10, None)]:
        x, c = _clustered(n, d, k, gen, dev)
        if mask == "holes":
            valid = (torch.rand((n,), generator=gen, device=dev) < 0.7).float()
        elif mask is None:
            valid = None
        else:
            valid = (torch.arange(n, device=dev) < mask).float()
        s, cnt, inertia = kmeans_update(x, c, valid)
        s_ref, cnt_ref, inertia_ref = kmeans_update_reference(
            x, c, torch.ones((n,), device=dev) if valid is None else valid)
        require(torch.equal(cnt, cnt_ref), f"kmeans_update {n, d, k}: "
                "counts differ")
        # fp32 sums over up to 32k rows in another order than the plain
        # version's matmul: the JAX suite's rtol 1e-4 / atol 1e-3
        e_s = max_err(s, s_ref, 1e-3, 1e-4, f"kmeans_update sums {n, d, k}")
        e_i = max_err(inertia, inertia_ref[0], 1e-3, 1e-4,
                      f"kmeans_update inertia {n, d, k}")
        again = kmeans_update(x, c, valid)
        require(all(torch.equal(a, b) for a, b in zip((s, cnt, inertia),
                                                      again)),
                f"kmeans_update {n, d, k}: two runs are not bitwise equal")
        err = max(err, e_s, e_i)
    # the build's shape: store capacity rows, the first n_valid_main live
    n, d, k = 32768, 128, 14
    x, c = _clustered(n, d, k, gen, dev)
    valid = (torch.arange(n, device=dev) < n_valid_main).float()
    want = kmeans_update(x, c, valid)
    # bitwise repeat, and blind to dead rows: other finite values in them,
    # and twice the capacity (the new rows dead) give the same bits
    dead = valid == 0
    x_other = x.clone()
    x_other[dead] = 10.0 * torch.randn((int(dead.sum()), d), generator=gen,
                                       device=dev)
    x_big = torch.cat([x, torch.randn((n, d), generator=gen, device=dev)])
    v_big = torch.cat([valid, torch.zeros((n,), device=dev)])
    for what, args in (("a second call", (x, c, valid)),
                       ("other dead rows", (x_other, c, valid)),
                       (f"capacity {2 * n}", (x_big, c, v_big))):
        got = kmeans_update(*args)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"kmeans_update at the build's shape: {what} is not "
                "bitwise equal")
    log(f"  kmeans_update [N={n} valid {n_valid_main}]: bitwise equal on a "
        f"second call, with other dead rows and at capacity {2 * n}")
    attrs = kmeans_resources("update")
    ms, wrapper_ms = kernel_ms(lambda: kmeans_update(x, c, valid), reps=100)
    plain_ms = cuda_ms(lambda: kmeans_update_reference(x, c, valid), reps=100)
    nv = n_valid_main       # only the live rows matter to the result
    nbytes = 4 * (nv * d + n + k * d) + 4 * (k * d + k + 1)
    flops = nv * (2 * k * d + 2 * d + 3 * k + d)
    return dict(err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                library_ms=None,
                bound=bound(nbytes, flops),
                shape=f"N={n} (valid {nv}) d={d} K={k}",
                extra=dict(registers=attrs["registers"],
                           local_bytes=attrs["local_bytes"]))


# ---------------------------------------------------------------- phase 3

def cross_check_full_width(programs, intervals):
    """Full-width models from one seed on the CPU (plain versions) and on
    the card (kernels), on a small input."""
    from repro_torch.core.pipeline import SemanticBBVPipeline
    blocks = [b for p in programs[:2] for b in p.unique_blocks][:32]
    ivs = intervals[programs[0].name][:24]
    table = {}
    out = {}
    for dev in ("cpu", "cuda"):
        pipe = SemanticBBVPipeline.create(seed=SEED, device=dev)
        bbes = pipe.encode_blocks(blocks, batch=32)
        if not table:
            table = {b.bid: np.random.RandomState(b.bid % 2**31).randn(
                pipe.sig_cfg.bbe_dim).astype(np.float32)
                for p in programs[:1] for b in p.unique_blocks}
        out[dev] = (np.stack([bbes[b.bid] for b in blocks]),
                    pipe.interval_signatures(ivs, table, batch=32))
    e_bbe = float(np.abs(out["cpu"][0] - out["cuda"][0]).max())
    e_sig = float(np.abs(out["cpu"][1] - out["cuda"][1]).max())
    log(f"  full width, CPU plain vs card kernels: BBE max err {e_bbe:.3g} "
        f"({len(blocks)} blocks), signature max err {e_sig:.3g} "
        f"({len(ivs)} intervals)")
    require(e_bbe <= 1e-4, f"BBE CPU vs card: {e_bbe} > 1e-4")
    require(e_sig <= 1e-4, f"signature CPU vs card: {e_sig} > 1e-4")


def cross_check_stage2_grads(programs, intervals, cpis):
    """Stage-2 loss gradients of the full-width model (default
    SignatureConfig) on the CPU (plain versions) and on the card (both
    set-attention kernels), on one small triplet batch, every parameter
    within the JAX suite's gradient bound."""
    from repro_torch.core.pipeline import BBEIndex
    from repro_torch.core.signature import (
        SignatureConfig, SignatureModel, stage2_loss_from_rows,
    )
    from repro_torch.train import triplet_row_batch
    cfg = SignatureConfig()
    names = [p.name for p in programs[:-1]]
    rng = np.random.RandomState(SEED)
    table = {b.bid: rng.randn(cfg.bbe_dim).astype(np.float32)
             for p in programs for b in p.unique_blocks}
    index = BBEIndex(table)
    sets, anchor_cpis = stage2_triplets(names, intervals, cpis,
                                        _phases(names, intervals), 0, 8)
    grads = {}
    for dev in ("cpu", "cuda"):
        model = SignatureModel(cfg, seed=SEED).to(dev)
        batch = triplet_row_batch(sets, anchor_cpis, index, cfg.max_set,
                                  device=dev)
        loss, _ = stage2_loss_from_rows(
            model, cfg, torch.from_numpy(index.ext).to(dev), batch)
        named = dict(model.named_parameters())
        gs = torch.autograd.grad(loss, list(named.values()),
                                 allow_unused=True)
        require(all(g is not None for g in gs),
                f"{dev}: a parameter got no Stage-2 gradient")
        grads[dev] = {n: g.cpu() for n, g in zip(named, gs)}
    err = max(max_err(grads["cuda"][n], g, 1e-4, 1e-3, f"stage-2 grad {n}")
              for n, g in grads["cpu"].items())
    log(f"  full width, CPU plain vs card kernels: Stage-2 gradients max err "
        f"{err:.3g} over {len(grads['cpu'])} parameters (8 triplets)")


def cross_check_stage1_grads():
    """Stage-1 pre-training loss gradients of the full-width encoder
    (default BBEConfig) on the CPU (plain versions) and on the card (both
    wkv kernels), on a corpus batch of 4, every parameter within the JAX
    suite's gradient bound."""
    from repro_torch.core.bbe import BBEConfig, BBEEncoder, pretrain_loss
    from repro_torch.data.corpus import SyntheticBinaryCorp
    cfg = BBEConfig()
    corp = SyntheticBinaryCorp(n_functions=500, max_len=cfg.max_len)
    toks = torch.from_numpy(corp.pretrain_batch(0, 4)["tokens"])
    grads, losses = {}, {}
    for dev in ("cpu", "cuda"):
        model = BBEEncoder(cfg, seed=SEED).to(dev)
        loss, _ = pretrain_loss(model, {"tokens": toks.to(dev)})
        named = dict(model.named_parameters())
        gs = torch.autograd.grad(loss, list(named.values()),
                                 allow_unused=True, materialize_grads=True)
        grads[dev] = {n: g.cpu() for n, g in zip(named, gs)}
        losses[dev] = float(loss.detach())
    err = max(max_err(grads["cuda"][n], g, 1e-4, 1e-3, f"stage-1 grad {n}")
              for n, g in grads["cpu"].items())
    log(f"  full width, CPU plain vs card kernels: Stage-1 pre-training loss "
        f"{losses['cpu']:.6f} / {losses['cuda']:.6f}, gradients max err "
        f"{err:.3g} over {len(grads['cpu'])} parameters (4 x 128 tokens)")


# ---------------------------------------------------------------- phase 4

def make_world():
    from repro_torch.data.asmgen import spec_programs
    from repro_torch.data.perfmodel import INORDER_CPU, interval_cpi
    from repro_torch.data.trace import trace_program
    programs = spec_programs("int") + spec_programs("fp")
    blocks = {b.bid: b for p in programs for b in p.unique_blocks}
    intervals = {p.name: trace_program(p, N_INTERVALS, seed=SEED)
                 for p in programs}
    cpis = {n: [interval_cpi(iv, blocks, INORDER_CPU) for iv in ivs]
            for n, ivs in intervals.items()}
    return programs, blocks, intervals, cpis


def main_path(programs, blocks, intervals, cpis, dtype="float32",
              stages=None):
    """The serving path at the default configs of `dtype`; each stage's
    wall seconds go into `stages`."""
    from repro_torch.api import SemanticBBVService, ServiceConfig
    from repro_torch.core.bbe import BBEConfig
    from repro_torch.core.signature import SignatureConfig
    names = [p.name for p in programs]
    held_out = names[-1]
    stages = {} if stages is None else stages

    t = time.perf_counter()
    svc = SemanticBBVService.create(ServiceConfig(
        seed=SEED, k=14, bbe=BBEConfig(dtype=dtype),
        sig=SignatureConfig(dtype=dtype)), device="cuda")
    torch.cuda.synchronize()
    stages["create"] = time.perf_counter() - t

    t = time.perf_counter()
    n_bbe = svc.ingest_blocks(list(blocks.values()))
    stages["ingest_blocks"] = time.perf_counter() - t

    t = time.perf_counter()
    for n in names[:-1]:
        svc.ingest_intervals(n, intervals[n], cpis=cpis[n])
    stages["ingest_intervals"] = time.perf_counter() - t

    t = time.perf_counter()
    kb = svc.build()
    stages["build"] = time.perf_counter() - t

    t = time.perf_counter()
    svc.attach_many({held_out: intervals[held_out]},
                    cpis={held_out: cpis[held_out]})
    stages["attach_many"] = time.perf_counter() - t

    t = time.perf_counter()
    ests = {n: svc.estimate(n) for n in names}
    stages["estimate"] = time.perf_counter() - t

    store = svc.store
    sigs = np.asarray(store.signatures)
    sig_dim = svc.pipe.sig_cfg.sig_dim
    require(sigs.shape == (len(names) * N_INTERVALS, sig_dim),
            f"store holds {sigs.shape}")
    require(bool(np.isfinite(sigs).all()), "non-finite signatures")
    norms = np.linalg.norm(sigs, axis=-1)
    require(bool(np.all(np.abs(norms - 1.0) < 1e-4)),
            f"signatures not unit-norm: {norms.min()}..{norms.max()}")
    require(len(svc.bbe_table) == n_bbe == len(blocks), "BBE table size")
    require(kb.k == 14 and kb.archetypes.shape == (14, sig_dim),
            "archetypes")
    for n, e in ests.items():
        require(np.isfinite(e.est_cpi), f"{n}: est_cpi {e.est_cpi}")
        require(e.accuracy is not None and 0.0 <= e.accuracy <= 1.0,
                f"{n}: accuracy {e.accuracy}")
        require(abs(e.fingerprint.sum() - 1.0) < 1e-9, f"{n}: fingerprint")
    for stage, sec in stages.items():
        log(f"  stage {stage}: {sec:.3f} s")
    log(f"  store: {len(store)} rows, capacity {store.capacity} x "
        f"{store.sig_dim} fp32; {len(blocks)} blocks, k = {kb.k}")
    log(f"  estimates: avg accuracy {kb.avg_accuracy:.4f} (untrained "
        f"weights), held-out {held_out}: est {ests[held_out].est_cpi:.4f} "
        f"true {ests[held_out].true_cpi:.4f}, speedup "
        f"{ests[held_out].speedup:.1f}x")
    return svc


def repeated_builds(svc, n: int = 5) -> None:
    """Median wall seconds of `n` more `build(k=14)` calls on the service's
    store (host clock around a call that ends in a synchronise), with the
    k-means launches of each."""
    from repro_torch.kernels.kmeans_assign import kmeans_assign, kmeans_update
    walls, counts = [], set()
    for _ in range(n):
        u0, a0 = kmeans_update.launches, kmeans_assign.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        svc.build(k=14)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        counts.add((kmeans_update.launches - u0, kmeans_assign.launches - a0))
    require(len(counts) == 1, f"builds launched the kernels unevenly: {counts}")
    (n_update, n_assign), = counts
    log(f"  build(k=14) x {n} more on the same store: median "
        f"{1e3 * float(np.median(walls)):.3f} ms (min {1e3 * min(walls):.3f}"
        f", max {1e3 * max(walls):.3f}); a build launches kmeans_update "
        f"{n_update} and kmeans_assign {n_assign} times")


# --------------------------------------------------------------- phase 4b

# The store arrays the reload in a fresh process is held to.
STORE_ARRAYS = ("signatures", "weights", "cpis", "alive_mask", "uids",
                "inserted_at", "last_used")

# (4b) run by `python3 -c` in a fresh process with PYTHONPATH=src: load
# the store and knowledge base a service saved in argv[1] onto the device
# argv[3], estimate every program, and print the estimates, the digests
# of the store arrays named in argv[2] and the wall seconds of load +
# estimates (the device context started before the clock) as one JSON
# line.
RELOAD_CHILD = """
import hashlib, json, sys, time
import numpy as np, torch
from repro_torch.api import KnowledgeBase, SignatureStore
torch.zeros(1, device=sys.argv[3]).sum().item()   # the device is up
t = time.perf_counter()
store = SignatureStore.load(sys.argv[1] + "/store", device=sys.argv[3])
kb = KnowledgeBase.load(sys.argv[1] + "/knowledge", store)
ests = {p: kb.estimate(p) for p in store.programs if store.rows_for(p).size}
store.device_matrix.sum().item()
wall = time.perf_counter() - t
print(json.dumps({"wall": wall, "estimates": {
    p: {"est_cpi": e.est_cpi, "true_cpi": e.true_cpi,
        "accuracy": e.accuracy} for p, e in ests.items()},
    "arrays": {n: hashlib.sha256(np.ascontiguousarray(
        getattr(store, n)).tobytes()).hexdigest()
        for n in sys.argv[2].split(",")}}))
"""


def _digests(store) -> dict:
    import hashlib
    return {n: hashlib.sha256(np.ascontiguousarray(
        getattr(store, n)).tobytes()).hexdigest() for n in STORE_ARRAYS}


def _timed(fn, dev):
    """(fn(), wall seconds) on the host clock, `dev` synchronised on both
    sides."""
    sync(dev)
    t = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t


def lifecycle(svc, programs, intervals) -> dict:
    """(4b) The lifecycle path on phase 4's service (19 programs x 1,000
    rows, capacity 32,768): a vacuum whose LRU policy evicts the 3 least
    recently estimated programs, the survivors' estimates, a rebuild on
    the compacted store, a save, and a pure-query attach of an evicted
    program's intervals, each with its host gates. Launches no kernel
    but the path's; returns what `lifecycle_witness` holds it to."""
    from repro_torch.api import EvictionPolicy, KnowledgeBase
    from repro_torch.kernels.kmeans_assign import kmeans_assign, kmeans_update
    names = [p.name for p in programs]
    store, kb = svc.store, svc.kb
    require((len(store), store.n_alive, store.capacity)
            == (19 * N_INTERVALS, 19 * N_INTERVALS, 32768),
            f"store before the vacuum: {len(store)} rows, capacity "
            f"{store.capacity}")
    evicted = names[:3]        # phase 4 estimated the programs in order
    before = {n: kb.estimate(n) for n in names}
    rep_cpi = kb.rep_cpi.copy()
    on_evicted = sum(p in evicted for p in kb.rep_program)

    dev = store.device
    report, t_vacuum = _timed(
        lambda: svc.vacuum(EvictionPolicy(max_rows=16_000)), dev)
    require(report.evicted == 3000 and report.compacted
            and report.rows_after == 16_000
            and report.capacity_after == 16_384
            and report.repinned == on_evicted,
            f"vacuum report {report}, {on_evicted} representatives on the "
            "evicted programs")
    require(store.programs == names[3:], f"survivors {store.programs}")
    require(np.array_equal(kb.rep_cpi, rep_cpi), "rep_cpi changed")
    require(bool(store.alive_mask[kb.rep_global_idx].all()),
            "a representative sits on a dead row")
    for n in names[3:]:
        a, b = kb.estimate(n), before[n]
        require((a.est_cpi, a.true_cpi, a.accuracy)
                == (b.est_cpi, b.true_cpi, b.accuracy)
                and np.array_equal(a.fingerprint, b.fingerprint),
                f"{n}: estimate moved across the vacuum")

    u0, a0 = kmeans_update.launches, kmeans_assign.launches
    built, t_build = _timed(lambda: KnowledgeBase(store).build(k=14, seed=0),
                            dev)
    build_launches = (kmeans_update.launches - u0, kmeans_assign.launches - a0)
    require(build_launches == (75, 4),
            f"the rebuild launched {build_launches}, not (75, 4)")

    out = os.path.join(HERE, "build", "chip_smoke_kb")
    shutil.rmtree(out, ignore_errors=True)
    _, t_save = _timed(lambda: svc.save(out), dev)

    ev = evicted[0]
    v0, n0 = store.version, len(store)
    f = svc.attach_intervals(ev, intervals[ev])
    require(abs(float(f.sum()) - 1.0) < 1e-9 and f.shape == (14,),
            f"attach_intervals fingerprint {f}")
    require(ev not in kb.fingerprints and ev not in store
            and (store.version, len(store)) == (v0, n0),
            "attach_intervals recorded something")
    log(f"  vacuum (LRU max_rows 16,000): evicted {report.evicted} rows of "
        f"{', '.join(evicted)}, rows {report.rows_before} -> "
        f"{report.rows_after}, capacity {report.capacity_before} -> "
        f"{report.capacity_after}, {report.repinned} representatives "
        f"re-pinned, in {1e3 * t_vacuum:.3f} ms; 16 survivors' estimates "
        "bitwise unchanged")
    log(f"  build(k=14) on the compacted store {1e3 * t_build:.3f} ms, "
        f"{build_launches[0]} kmeans_update and {build_launches[1]} "
        f"kmeans_assign launches; save {1e3 * t_save:.3f} ms")
    log(f"  attach_intervals({ev}, {len(intervals[ev])} intervals): "
        "fingerprint sums to 1, nothing recorded")
    return dict(built=built, build_launches=build_launches, out=out)


def lifecycle_witness(svc, path: dict) -> None:
    """(4b) What the lifecycle path is held to, after its launches were
    read: the compacted matrix bitwise a fresh upload of the live rows,
    the rebuild bitwise a build over that fresh store, and a reload of
    the save in a fresh process bitwise its summary.json."""
    from repro_torch.api import KnowledgeBase, SignatureStore
    from repro_torch.kernels.kmeans_assign import kmeans_assign, kmeans_update
    store = svc.store
    dev = store.device
    fresh = SignatureStore(store.sig_dim, min_capacity=store.min_capacity,
                           device=dev)
    for n in store.programs:
        rows = store.rows_for(n)
        fresh.add(n, store.signatures[rows], store.weights[rows],
                  store.cpis[rows])
    require(fresh.capacity == store.capacity
            and torch.equal(store.device_matrix.view(torch.int32),
                            fresh.device_matrix.view(torch.int32)),
            "the compacted device matrix is not bitwise a fresh upload")

    u0, a0 = kmeans_update.launches, kmeans_assign.launches
    kb2, t_fresh = _timed(lambda: KnowledgeBase(fresh).build(k=14, seed=0),
                          dev)
    fresh_launches = (kmeans_update.launches - u0,
                      kmeans_assign.launches - a0)
    require(fresh_launches == path["build_launches"],
            f"the fresh store's build launched {fresh_launches}, the "
            f"compacted store's {path['build_launches']}")
    kb1 = path["built"]
    require(np.array_equal(kb1.archetypes, kb2.archetypes)
            and np.array_equal(kb1.rep_global_idx, kb2.rep_global_idx)
            and np.array_equal(kb1._all_row_assign(), kb2._all_row_assign())
            and all(np.array_equal(f, kb2.fingerprints[p])
                    for p, f in kb1.fingerprints.items()),
            "the build over the compacted store is not bitwise a fresh "
            "store's")

    out = path["out"]
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", RELOAD_CHILD, out,
                          ",".join(STORE_ARRAYS), str(dev)], env=env,
                         capture_output=True, text=True, timeout=300)
    t_child = time.perf_counter() - t
    require(run.returncode == 0, f"reload process failed:\n{run.stderr}")
    child = json.loads(run.stdout.strip().splitlines()[-1])
    require(sorted(summary["estimates"]) == sorted(store.programs)
            and child["estimates"] == summary["estimates"],
            "the reloaded estimates are not bitwise summary.json's")
    require(child["arrays"] == _digests(store),
            "the reloaded store's arrays differ from the saved store's")
    log("  the compacted matrix bitwise a fresh upload; build(k=14) on a "
        f"fresh store of the live rows {1e3 * t_fresh:.3f} ms, bitwise the "
        "compacted store's build")
    log(f"  reload in a fresh process: load + {len(child['estimates'])} "
        f"estimates {1e3 * child['wall']:.3f} ms on its clock, its device "
        f"context up first ({t_child:.1f} s with the process start); "
        "estimates bitwise summary.json's, store arrays equal")


# --------------------------------------------------------------- phase 4c

SIMPOINT_K = 10           # Fig. 4's k-means budget
SIMPOINT_PROJECT = 15     # SimPoint 3.0's projection of the classic BBV


def simpoint_flow(programs, blocks, intervals, cpis, semantic,
                  dev="cuda") -> dict:
    """(4c) Fig. 4's flow for every program: SimPoint over its classic
    BBV (every block, length-weighted, projected to 15 dims) and over its
    semantic signatures (`semantic`, copied from the store before 4b), k
    10, instruction weights, on the card. Returns the classic BBVs."""
    from repro_torch.core.simpoint import classic_bbv_matrix, run_simpoint
    from repro_torch.kernels.kmeans_assign import kmeans_assign, kmeans_update
    order = sorted(blocks)
    lens = {b: blk.num_instrs for b, blk in blocks.items()}
    names = [p.name for p in programs]
    t = time.perf_counter()
    bbvs = {n: classic_bbv_matrix(intervals[n], order, lens) for n in names}
    t_bbv = time.perf_counter() - t
    u0, a0 = kmeans_update.launches, kmeans_assign.launches
    acc = {"bbv": [], "semantic": []}
    t = time.perf_counter()
    for n in names:
        w = np.array([iv.num_instrs for iv in intervals[n]], np.float64)
        c = np.asarray(cpis[n], np.float64)
        for kind, x, proj in (("bbv", bbvs[n], SIMPOINT_PROJECT),
                              ("semantic", semantic[n], 0)):
            res = run_simpoint(x, c, w, k=SIMPOINT_K, seed=SEED,
                               project_to=proj, device=dev)
            require(res.assign.shape == (N_INTERVALS,)
                    and res.rep_indices.shape == (SIMPOINT_K,)
                    and np.isfinite(res.accuracy),
                    f"{n} {kind}: SimPoint result {res}")
            acc[kind].append(res.accuracy)
    sync(dev)
    wall = time.perf_counter() - t
    n_update = kmeans_update.launches - u0
    n_assign = kmeans_assign.launches - a0
    runs, restarts, iters = 2 * len(names), 3, 25
    require((n_update, n_assign) == (runs * restarts * iters,
                                     runs * restarts),
            f"SimPoint launched kmeans_update {n_update} and kmeans_assign "
            f"{n_assign} times")
    log(f"  SimPoint (k {SIMPOINT_K}) over {len(names)} programs x "
        f"{N_INTERVALS} intervals: mean accuracy classic BBV (projected to "
        f"{SIMPOINT_PROJECT}) {np.mean(acc['bbv']):.4f}, semantic "
        f"(untrained weights) {np.mean(acc['semantic']):.4f}; "
        f"{wall:.3f} s on the card (+ {t_bbv:.3f} s of BBVs on the host), "
        f"kmeans_update {n_update} and kmeans_assign {n_assign} launches")
    return bbvs


def simpoint_card_vs_cpu(names, bbvs, semantic, dev="cuda") -> None:
    """(4c) On two programs, SimPoint's k-means on the card (kernels)
    against the CPU (plain versions) from the same seeds: labels equal
    but for ties within 1e-5, representatives equal, centroids within
    1e-4."""
    from repro_torch.core.clustering import (
        kmeans, kmeans_pp_init, representatives,
    )
    from repro_torch.core.simpoint import random_projection
    for n in names[:2]:
        for kind, x in (("bbv", random_projection(
                bbvs[n], SIMPOINT_PROJECT, SEED).astype(np.float32)),
                ("semantic", semantic[n].astype(np.float32))):
            xt = torch.from_numpy(x)
            init = torch.stack([kmeans_pp_init(
                torch.Generator().manual_seed(r), xt, SIMPOINT_K)
                for r in range(3)])
            got = kmeans(x, SIMPOINT_K, device=dev, init_centroids=init)
            want = kmeans(x, SIMPOINT_K, device="cpu", init_centroids=init)
            d2 = ((x[:, None, :].astype(np.float64)
                   - want[0][None, :, :].astype(np.float64)) ** 2).sum(-1)
            two = np.sort(d2, axis=1)[:, :2]
            differ = got[1] != want[1]
            require(bool((two[differ, 1] - two[differ, 0] <= 1e-5).all()),
                    f"{n} {kind}: card and CPU labels differ beyond ties")
            require(np.array_equal(representatives(x, *got[:2]),
                                   representatives(x, *want[:2])),
                    f"{n} {kind}: card and CPU representatives differ")
            err = float(np.abs(got[0] - want[0]).max())
            require(err <= 1e-4, f"{n} {kind}: centroids {err} apart")
            log(f"  {n} {kind} (d {x.shape[1]}): card vs CPU k-means from "
                f"the same seeds: {int(differ.sum())} labels differ (ties), "
                f"representatives equal, centroids max err {err:.3g}")


# ---------------------------------------------------------------- phase 5

def _phases(names, intervals):
    """{program: {phase_id: [interval index, ...]}} in first-seen order,
    as `_stage2_triplets` builds it per draw."""
    out = {}
    for n in names:
        phases = {}
        for i, iv in enumerate(intervals[n]):
            phases.setdefault(iv.phase_id, []).append(i)
        out[n] = phases
    return out


def stage2_triplets(names, intervals, cpis, phases, step, batch):
    """Copy of benchmarks/lab.py::_stage2_triplets (the paper's triplet
    policy): anchor and positive from the same program and phase, the
    negative from another program, seeded from the step."""
    from repro_torch.data.isa import stable_hash
    from repro_torch.data.perfmodel import INORDER_CPU
    rng = np.random.RandomState(stable_hash("s2", INORDER_CPU.name, step))
    sets = {k: [] for k in ("anchor", "positive", "negative")}
    out_cpis = []
    for _ in range(batch):
        pa, pn = rng.choice(names, 2, replace=False)
        ph = rng.choice(list(phases[pa]))
        ia = int(rng.choice(phases[pa][ph]))
        ip = int(rng.choice(phases[pa][ph]))
        inn = int(rng.randint(len(intervals[pn])))
        sets["anchor"].append(intervals[pa][ia])
        sets["positive"].append(intervals[pa][ip])
        sets["negative"].append(intervals[pn][inn])
        out_cpis.append(cpis[pa][ia])
    return sets, out_cpis


def train_stage2(svc, programs, intervals, cpis):
    """Stage-2 training on the card at full width; returns the set-attention
    (forward, backward) launches of the phase."""
    from repro_torch.config import TrainConfig
    from repro_torch.core.signature import stage2_loss_from_rows
    from repro_torch.kernels.set_attention import (
        masked_set_attention, set_attention_backward,
    )
    from repro_torch.train import Stage2Engine, triplet_row_batch
    names = [p.name for p in programs[:-1]]       # the 18 ingested programs
    pipe = svc.pipe
    cfg = pipe.sig_cfg
    index, matrix = pipe._table_index(svc.bbe_table)
    phases = _phases(names, intervals)

    def batch_fn(step):
        sets, anchor_cpis = stage2_triplets(names, intervals, cpis, phases,
                                            step, TRAIN_BATCH)
        return triplet_row_batch(sets, anchor_cpis, index, cfg.max_set,
                                 device=matrix.device)

    ckdir = os.path.join(HERE, "build", "chip_smoke_stage2")
    shutil.rmtree(ckdir, ignore_errors=True)
    tc = TrainConfig(learning_rate=1e-3, total_steps=TRAIN_STEPS,
                     warmup_steps=2, checkpoint_every=10,
                     checkpoint_dir=os.path.join(ckdir, "run"))

    def loss_of(eng, batch):
        with torch.no_grad():
            return float(stage2_loss_from_rows(eng.model, cfg, eng.matrix,
                                               batch)[0])

    t_phase = time.perf_counter()
    eng = Stage2Engine(cfg, pipe.sig_model, matrix, tc)
    batch0 = batch_fn(0)
    before = loss_of(eng, batch0)
    bwd0 = set_attention_backward.launches
    step_s = []
    for step in range(TRAIN_STEPS):
        t = time.perf_counter()
        m = eng.step(batch_fn(step))
        eng.maybe_checkpoint()
        step_s.append(time.perf_counter() - t)
        require(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
                f"step {step}: loss {m['loss']}, grad_norm {m['grad_norm']}")
        log(f"  step {step:2d}: loss {m['loss']:.5f} grad_norm "
            f"{m['grad_norm']:.4f} lr {m['lr']:.2e} wall "
            f"{1e3 * step_s[-1]:.2f} ms")
    require(set_attention_backward.launches - bwd0 == 9 * TRAIN_STEPS,
            f"set_attention_backward launched "
            f"{set_attention_backward.launches - bwd0} times in "
            f"{TRAIN_STEPS} steps, not 9 a step")
    after = loss_of(eng, batch0)
    log(f"  loss of the step-0 batch: {before:.5f} before, {after:.5f} after "
        f"{TRAIN_STEPS} steps")
    require(after < before, "training did not lower the step-0 batch's loss")

    # exact resume: a fresh engine from the same start, restored from the
    # step-10 checkpoint, run to the end
    resumed_dir = os.path.join(ckdir, "resumed")
    os.makedirs(resumed_dir)
    shutil.copytree(os.path.join(tc.checkpoint_dir, "step_0000000010"),
                    os.path.join(resumed_dir, "step_0000000010"))
    bwd0 = set_attention_backward.launches
    eng_b = Stage2Engine(cfg, pipe.sig_model, matrix,
                         dataclasses.replace(tc, checkpoint_dir=resumed_dir))
    t = time.perf_counter()
    eng_b.fit(batch_fn, TRAIN_STEPS, log_every=TRAIN_STEPS)
    resume_s = time.perf_counter() - t
    require(set_attention_backward.launches - bwd0 == 9 * (TRAIN_STEPS - 10),
            "the resumed run did not take 10 steps through the kernels")
    differ = [n for n, p in eng.params.items()
              if not torch.equal(p, eng_b.params[n])]
    require(not differ, f"resume from step 10 is not bitwise equal: {differ}")
    total = time.perf_counter() - t_phase
    log(f"  step wall time: median {1e3 * float(np.median(step_s)):.2f} ms, "
        f"first {1e3 * step_s[0]:.2f} ms, sum {sum(step_s):.3f} s "
        f"({TRAIN_STEPS} steps of {TRAIN_BATCH} triplets, checkpoints "
        f"included); resume 10 steps {resume_s:.3f} s; bitwise equal "
        f"({len(eng.params)} parameters)")
    log(f"  stage-2 training phase: {total:.3f} s")
    return masked_set_attention.launches, set_attention_backward.launches


# --------------------------------------------------------------- phase 5b

STAGE1_PARAMS = 24_915_168   # fp32 parameters of the default BBEConfig


def _stage1_loaders(cfg, dev):
    """Phase 5b's data, as launch/train.py builds it: a SyntheticBinaryCorp
    of 500 functions; pre-training batches of STAGE1_BATCH token rows and
    triplet batches of TRIPLET_BATCH, each a pure function of the step,
    moved to the card by the port's BatchLoader."""
    from repro_torch.data import BatchLoader, SyntheticBinaryCorp
    corp = SyntheticBinaryCorp(n_functions=500, max_len=cfg.max_len)
    pre = BatchLoader(lambda s: {"tokens": corp.pretrain_batch(
        s, STAGE1_BATCH)["tokens"]}, device=dev)
    tri = BatchLoader(lambda s: corp.triplet_batch(s, TRIPLET_BATCH),
                      device=dev)
    return pre, tri


def _stage1_run(trainer, batches, steps, per_step, what):
    """`steps` Trainer steps on batches(step); each must launch the wkv
    forward and backward kernels `per_step` times and give a finite loss.
    Returns (step seconds, batch-assembly seconds, losses)."""
    from repro_torch.kernels.wkv import wkv, wkv_backward
    step_s, batch_s, losses = [], [], []
    for step in range(steps):
        t = time.perf_counter()
        batch = batches(step)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t)
        f0, b0 = wkv.launches, wkv_backward.launches
        t = time.perf_counter()
        m = trainer.step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        saved = trainer.maybe_checkpoint()
        ck_s = time.perf_counter() - t
        require(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
                f"{what} step {step}: loss {m['loss']}, grad_norm "
                f"{m['grad_norm']}")
        n = (wkv.launches - f0, wkv_backward.launches - b0)
        require(n == (per_step, per_step),
                f"{what} step {step}: wkv forward/backward launched {n}, not "
                f"{per_step} each")
        losses.append(m["loss"])
        log(f"  {what} step {step:2d}: loss {m['loss']:.5f} "
            + " ".join(f"{k} {m[k]:.5f}" for k in m
                       if k not in ("loss", "grad_norm", "lr"))
            + f" grad_norm {m['grad_norm']:.4f} lr {m['lr']:.2e} step "
            f"{1e3 * step_s[-1]:.2f} ms, batch {1e3 * batch_s[-1]:.2f} ms"
            + (f", checkpoint {1e3 * ck_s:.1f} ms" if saved else ""))
    return step_s, batch_s, losses


def _stage1_report(what, step_s, batch_s, losses, rows, length, peak):
    med = float(np.median(step_s))
    log(f"  {what}: step median {1e3 * med:.2f} ms (first "
        f"{1e3 * step_s[0]:.2f}), {rows * length / med:.0f} tokens/s ({rows} x {length} tokens a "
        f"step), host "
        f"batch assembly median {1e3 * float(np.median(batch_s)):.2f} ms a "
        f"step, peak device memory {peak / 2**30:.3f} GiB (after "
        f"gc.collect()), loss first {losses[0]:.5f} last {losses[-1]:.5f}")


def _peak_reset():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def train_stage1(dev="cuda") -> dict:
    """(5b) Stage-1 training on the card at the paper's width (default
    BBEConfig, seeded untrained weights): STAGE1_STEPS pre-training steps
    (NTP + NIP, lr 2e-3, the example's TrainConfig) with a checkpoint
    every 10, then TRIPLET_STEPS triplet fine-tuning steps (lr 1e-3).
    Returns what the resume witness needs."""
    from repro_torch.config import TrainConfig
    from repro_torch.core.bbe import (
        BBEConfig, BBEEncoder, finetune_triplet_loss, pretrain_loss,
    )
    from repro_torch.train import Trainer
    cfg = BBEConfig()
    pre, tri = _stage1_loaders(cfg, dev)
    ckdir = os.path.join(HERE, "build", "chip_smoke_stage1")
    shutil.rmtree(ckdir, ignore_errors=True)
    tc = TrainConfig(learning_rate=2e-3, total_steps=STAGE1_STEPS,
                     warmup_steps=max(2, STAGE1_STEPS // 20),
                     checkpoint_every=10,
                     checkpoint_dir=os.path.join(ckdir, "run"))
    t_phase = time.perf_counter()
    encoder = BBEEncoder(cfg, seed=SEED).to(dev)
    n_params = sum(p.numel() for p in encoder.parameters())
    require(n_params == STAGE1_PARAMS, f"{n_params} Stage-1 parameters")
    _peak_reset()
    trainer = Trainer(pretrain_loss, encoder, tc)
    step_s, batch_s, losses = _stage1_run(trainer, pre, STAGE1_STEPS,
                                          cfg.num_layers, "pretrain")
    peak = torch.cuda.max_memory_allocated()
    _stage1_report("pre-training", step_s, batch_s, losses, STAGE1_BATCH,
                   cfg.max_len, peak)
    med = float(np.median(step_s))
    FP32_FIGURES["stage1"] = dict(
        step_ms=1e3 * med, tokens_per_s=STAGE1_BATCH * cfg.max_len / med,
        peak_gib=peak / 2 ** 30, where="phase 5b")
    final = {n: p.detach().clone() for n, p in trainer.state.params.items()}
    del trainer
    _peak_reset()
    ft = Trainer(finetune_triplet_loss, encoder, TrainConfig(
        learning_rate=1e-3, total_steps=TRIPLET_STEPS,
        warmup_steps=max(2, TRIPLET_STEPS // 20), checkpoint_every=0,
        checkpoint_dir=os.path.join(ckdir, "triplet")))
    step_s, batch_s, losses = _stage1_run(ft, tri, TRIPLET_STEPS,
                                          3 * cfg.num_layers, "triplet")
    _stage1_report("triplet fine-tuning", step_s, batch_s, losses,
                   3 * TRIPLET_BATCH, cfg.max_len,
                   torch.cuda.max_memory_allocated())
    del ft, encoder
    log(f"  stage-1 training phase: {time.perf_counter() - t_phase:.3f} s "
        f"({n_params} parameters)")
    return dict(cfg=cfg, tc=tc, final=final, loader=pre, dev=dev)


def stage1_witness(run: dict) -> None:
    """A fresh Trainer from the same start, restored from phase 5b's step-10
    checkpoint and run to step STAGE1_STEPS, ends with bitwise the weights
    of the uninterrupted run."""
    from repro_torch.core.bbe import BBEEncoder, pretrain_loss
    from repro_torch.train import Trainer
    tc = run["tc"]
    resumed = os.path.join(os.path.dirname(tc.checkpoint_dir), "resumed")
    os.makedirs(resumed)
    shutil.copytree(os.path.join(tc.checkpoint_dir, "step_0000000010"),
                    os.path.join(resumed, "step_0000000010"))
    t = time.perf_counter()
    trainer = Trainer(pretrain_loss,
                      BBEEncoder(run["cfg"], seed=SEED).to(run["dev"]),
                      dataclasses.replace(tc, checkpoint_dir=resumed))
    trainer.fit(run["loader"], STAGE1_STEPS, log_every=STAGE1_STEPS)
    require(trainer.state.step == STAGE1_STEPS, "the resumed run's step")
    differ = [n for n, p in run["final"].items()
              if not torch.equal(p, trainer.state.params[n])]
    require(not differ, f"stage-1 resume from step 10 is not bitwise equal: "
            f"{differ[:5]}")
    log(f"  stage-1 resume: 10 steps from the step-10 checkpoint in "
        f"{time.perf_counter() - t:.3f} s, bitwise equal "
        f"({len(run['final'])} parameters)")


# ---------------------------------------------------------------- phase 6

def _visible_pairs(S: int, T: int, causal: bool, window: int,
                   prefix_len: int = 0) -> int:
    """Unmasked (q, k) pairs of one head, positions from 0 for both; the
    causal rule widened by the prefix (k < prefix_len visible to all)."""
    q = np.arange(S)[:, None]
    k = np.arange(T)[None, :]
    vis = np.ones((S, T), bool)
    if causal:
        vis = (k <= q) | (k < prefix_len)
    if window > 0:
        vis = vis & (q - k < window)
    return int(vis.sum())


def _flash_bound(B, S, T, H, K, D, causal, prefix_len):
    """(bound_ms, bound_by) of one bf16 flash call: q, k, v read and o
    written once; 4 D operations a visible (q, k) pair at the bf16 peak."""
    nbytes = 2 * (2 * B * S * H * D + 2 * B * T * K * D)
    flops = 4 * D * B * H * _visible_pairs(S, T, causal, 0, prefix_len)
    return bound(nbytes, flops, PEAK_BF16_FLOP_PER_S)


def _flash_inputs(gen, dev, B, S, T, H, K, D, dtype):
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((B, S, H, D), (B, T, K, D), (B, T, K, D)))


def flash_err(got, want, fp32: bool, what: str) -> float:
    """Max |got - want| of a flash output against its plain version. fp32
    at the JAX suite's bound (atol 2e-5, rtol 1e-2); bf16 at atol 1e-2,
    rtol 1e-2 (one bf16 ulp is at most 2^-7 |x|), since a typical output
    of random q, k, v over hundreds of keys is only about 0.03-0.04. Both
    also hold the relative L2 error ||got - want|| / ||want|| to 1e-4
    (fp32) or 1e-2 (bf16): a dropped or doubled 64-key tile moves it by
    several percent."""
    err = max_err(got, want, 2e-5 if fp32 else 1e-2, 1e-2, what)
    rel = ((got - want).norm() / want.norm()).item()
    require(rel <= (1e-4 if fp32 else 1e-2),
            f"{what}: relative L2 error {rel:.3g}")
    log(f"  {what}: max abs err {err:.3g}, relative L2 error {rel:.3g}")
    return err


def check_flash_cases(dev, gen) -> float:
    """Both flash kernels against their plain version at every case of
    FLASH_CASES (`flash_err`), each launched twice with bitwise equal
    outputs, and a prefix past T bitwise the full mask. Returns the max
    abs error."""
    from repro_torch.kernels.flash_attention import (
        attention_reference, flash_attention,
    )
    err = 0.0
    for B, S, T, H, K, D, causal, window, P, fp32 in FLASH_CASES:
        dtype = torch.float32 if fp32 else torch.bfloat16
        q, k, v = _flash_inputs(gen, dev, B, S, T, H, K, D, dtype)
        kw = dict(causal=causal, window=window, prefix_len=P)
        o = flash_attention(q, k, v, **kw)
        case = (B, S, T, H, K, D, causal, f"window {window}", f"prefix {P}",
                str(dtype))
        require(o.dtype == dtype and bool(torch.isfinite(o).all()),
                f"flash {case}: dtype {o.dtype} or non-finite")
        e = flash_err(o.float(), attention_reference(q, k, v, **kw).float(),
                      fp32, f"flash {case}")
        require(torch.equal(o, flash_attention(q, k, v, **kw)),
                f"flash {case}: two launches are not bitwise equal")
        if P >= T and window == 0:
            require(torch.equal(o, flash_attention(q, k, v, causal=False)),
                    f"flash {case}: not bitwise the full mask")
        err = max(err, e)
        del q, k, v, o
    return err


def check_flash(dev, gen):
    """(6a) The flash kernel against its plain version at the zoo's head
    dims and the prefix rule (`check_flash_cases`), then timed at
    smollm-135m's prefill shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        attention_reference, flash_attention,
    )

    err = check_flash_cases(dev, gen)
    err = max(err, check_flash_layouts(dev, gen))
    from repro_torch.kernels import _lib
    attrs = {}
    for D in (64, 128, 256):
        attrs[D] = a = _lib.kernel_attributes("rt_flash_attention_attributes",
                                              1, D, 0, 0)
        log(f"  flash_attention bf16 (wgmma) instance for D <= {D}: "
            f"{describe(a)}")
    sass = sass_counts(str(_lib.build_library()), "flash_wgmma_kernel")
    hgmma = None if sass is None else sass["HGMMA*"]
    if hgmma is None:
        log("  HGMMA in the bf16 kernel's SASS: not checked (no cuobjdump)")
    else:
        log(f"  HGMMA in the bf16 kernel's SASS: {hgmma} instructions")
        require(hgmma > 0, "the bf16 flash kernel has no HGMMA instruction")

    B, S, _, H, K, D = FLASH_CASES[0][:6]
    q, k, v = _flash_inputs(gen, dev, B, S, S, H, K, D, torch.bfloat16)
    require(torch.equal(flash_attention(q, k, v), flash_attention(q, k, v)),
            "flash bf16: two launches are not bitwise equal")
    ms, wrapper_ms = kernel_ms(lambda: flash_attention(q, k, v), reps=20)
    plain_ms = cuda_ms(lambda: attention_reference(q, k, v), reps=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    e_lib = (sdpa().transpose(1, 2).float()
             - flash_attention(q, k, v).float()).abs().max()
    log(f"  flash_attention vs scaled_dot_product_attention: max abs diff "
        f"{e_lib.item():.3g} (yardstick only)")
    library_ms = cuda_ms(sdpa, reps=20)
    return dict(err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                library_ms=library_ms,
                bound=_flash_bound(B, S, S, H, K, D, True, 0),
                shape=f"B={B} S={S} H={H} K={K} D={D} bf16 causal",
                extra=dict(registers=attrs[64]["registers"],
                           local_bytes=attrs[64]["local_bytes"],
                           hgmma=hgmma))


def check_flash_layouts(dev, gen):
    """(6a) bf16 q, k, v as views of one fused projection (16-byte
    loads through the strides) and q at an odd element offset (element
    loads): both bit for bit the result of contiguous copies, and within
    the bf16 bound of the plain version."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import (
        attention_reference, flash_attention,
    )
    B, S, H, K, D = FLASH_VIEW_SHAPE
    qkv = torch.randn((B, S, (H + 2 * K) * D), generator=gen,
                      device=dev).bfloat16()
    q = qkv[..., :H * D].view(B, S, H, D)
    k = qkv[..., H * D:(H + K) * D].view(B, S, K, D)
    v = qkv[..., (H + K) * D:].view(B, S, K, D)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    q_odd = buf[1:].view(q.shape)
    q_odd.copy_(q)
    require(_lib.rows_aligned_16(q, k, v)
            and not _lib.rows_aligned_16(q_odd, k, v),
            "flash views: the load routes are not the ones meant")
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    err = 0.0
    for name, args in (("fused-projection views", (q, k, v)),
                       ("odd offset (element loads)", (q_odd, k, v))):
        o = flash_attention(*args)
        require(torch.equal(o, want), f"flash {name}: not bit for bit the "
                "contiguous copies' result")
        err = max(err, flash_err(o.float(), attention_reference(*args).float(),
                                 False, f"flash {name}"))
    log(f"  flash bf16 views of a fused projection and an odd offset: bit "
        f"for bit the contiguous result, max abs err {err:.3g}")
    return err


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _serve(model, params, prompts, dev, max_new, slots, max_seq):
    """Token lists, decode-step calls and wall seconds of one ServeEngine
    run over `prompts`."""
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(model, params, num_slots=slots, max_seq=max_seq,
                      device=dev)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=list(p), max_new=max_new))
    t = time.perf_counter()
    done = eng.run()
    sync(dev)
    return ({r: q.out for r, q in done.items()}, eng.decode_steps,
            time.perf_counter() - t)


def cross_check_zoo(dev):
    """(6b) smollm-135m at full width in fp32 from one seed on the CPU
    (plain versions) and on the card (kernels): hidden states of a
    256-token prefill, and 16 greedy tokens from the ServeEngine."""
    from repro_torch.config import get_arch
    from repro_torch.models.model_zoo import build_model
    cfg = dataclasses.replace(get_arch(ZOO_ARCH), dtype="float32",
                              param_dtype="float32")
    model = build_model(cfg)
    tokens = np.random.RandomState(SEED).randint(0, cfg.vocab_size, (1, 256))
    out = []
    for d in ("cpu", dev):
        t = time.perf_counter()
        params = model.init(SEED, device=d)
        hidden, _ = model.prefill(params, {"tokens": tokens})
        toks, _, _ = _serve(model, params, [tokens[0]], d, 16, 1, 512)
        out.append((hidden.cpu(), toks[0]))
        log(f"  {d}: prefill + 16 greedy tokens in "
            f"{time.perf_counter() - t:.1f} s")
        del params, hidden
    (h_cpu, t_cpu), (h_dev, t_dev) = out
    require(tuple(h_dev.shape) == (1, 256, cfg.d_model),
            f"hidden shape {tuple(h_dev.shape)}")
    err = max_err(h_dev, h_cpu, 1e-4, 1e-3,
                  "smollm fp32 hidden states, CPU vs card")
    require(t_dev == t_cpu and len(t_cpu) == 16,
            f"greedy tokens differ: CPU {t_cpu}, card {t_dev}")
    log(f"  full width fp32, CPU plain vs card kernels: hidden max err "
        f"{err:.3g} (1 x 256 tokens), 16 greedy tokens equal")


def zoo_path(dev):
    """(6c) smollm-135m in bf16 on the card: Model.prefill of 8 x 2048
    tokens, then the ServeEngine answering 24 requests twice."""
    from repro_torch.config import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model_zoo import build_model
    cfg = get_arch(ZOO_ARCH)
    model = build_model(cfg)
    V = cfg.vocab_size
    t = time.perf_counter()
    params = model.init(SEED, device=dev)
    sync(dev)
    log(f"  {cfg.name}: {model.param_count()} parameters ({cfg.param_dtype})"
        f", {cfg.num_layers} layers, drawn and moved in "
        f"{time.perf_counter() - t:.1f} s")
    rng = np.random.RandomState(SEED)
    tokens = torch.from_numpy(rng.randint(0, V, (PREFILL_BATCH, PREFILL_LEN))
                              ).to(dev)
    # earlier phases leave garbage in reference cycles (phase 5's engines):
    # collect it, so that the peak counts this phase's memory only
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for call in range(3):
        before = flash_attention.launches
        t = time.perf_counter()
        hidden, aux = model.prefill(params, {"tokens": tokens})
        sync(dev)
        walls.append(time.perf_counter() - t)
        require(flash_attention.launches - before == cfg.num_layers,
                f"prefill call {call}: {flash_attention.launches - before} "
                f"flash launches, not {cfg.num_layers}")
    require(tuple(hidden.shape) == (PREFILL_BATCH, PREFILL_LEN, cfg.d_model)
            and hidden.dtype == torch.bfloat16
            and bool(torch.isfinite(hidden).all()) and float(aux) == 0.0,
            f"prefill hidden {tuple(hidden.shape)} {hidden.dtype}")
    prefill_peak = torch.cuda.max_memory_allocated()
    wall = float(np.median(walls[1:]))
    n_tok = PREFILL_BATCH * PREFILL_LEN
    log(f"  prefill {PREFILL_BATCH} x {PREFILL_LEN}: wall {1e3 * wall:.2f} "
        f"ms (median of calls 2-3; first {1e3 * walls[0]:.2f} ms), "
        f"{n_tok / wall:.0f} tokens/s, peak device memory "
        f"{prefill_peak / 2**30:.3f} GiB")
    del hidden

    lens = rng.randint(16, 257, size=SERVE_REQUESTS)
    prompts = [rng.randint(0, V, n).tolist() for n in lens]
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    runs = [_serve(model, params, prompts, dev, SERVE_MAX_NEW,
                   SERVE_SLOTS, SERVE_MAX_SEQ) for _ in range(2)]
    outs, steps, serve_s = runs[0]
    require(sorted(outs) == list(range(SERVE_REQUESTS)),
            f"{len(outs)} of {SERVE_REQUESTS} requests completed")
    for r, out in outs.items():
        require(len(out) == SERVE_MAX_NEW and all(0 <= x < V for x in out),
                f"request {r}: {len(out)} tokens, or out of vocab")
    require(runs[1][0] == outs, "the repeated run gave other tokens")
    log(f"  serve: {SERVE_REQUESTS} requests (prompts {lens.min()}-"
        f"{lens.max()} tokens, {SERVE_MAX_NEW} new each) on {SERVE_SLOTS} "
        f"slots, max_seq {SERVE_MAX_SEQ}: {steps} decode steps (prefill "
        f"steps included) in {serve_s:.3f} s and {runs[1][2]:.3f} s, "
        f"{steps / serve_s:.1f} and {runs[1][1] / runs[1][2]:.1f} steps/s, "
        f"{SERVE_REQUESTS * SERVE_MAX_NEW / serve_s:.1f} new tokens/s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB; the repeat gave the same tokens")


# ---------------------------------------------------------------- phase 7

def _wkv_bound(B, S, H, dh):
    """(bound_ms, bound_by) of one wkv call: r k v w and beta read, y
    written, the state read and the final state written once; 7 dh^2
    operations a token and head."""
    nbytes = 4 * (5 * B * S * H * dh + B * S * H + 2 * B * H * dh * dh)
    return bound(nbytes, 7 * B * H * S * dh * dh)


def check_wkv_zoo(dev, gen) -> dict:
    """(7a) The wkv kernel at the recurrent zoo's shapes against its plain
    version, a random state in: the encoder's decode step on 8 slots (S 1,
    the state a view of a stacked cache, which must stay as it was) and
    its prefill of 8 x 2048 tokens; y and the final state at the JAX
    suite's bound, the device time (CUDA graph) beside the bound."""
    from repro_torch.kernels.wkv import wkv, wkv_reference
    out = {}
    for what, (B, S, H, dh) in (("decode", WKV_DECODE_SHAPE),
                                ("prefill", WKV_PREFILL_SHAPE)):
        r, k, v = (torch.randn((B, S, H, dh), generator=gen, device=dev)
                   for _ in range(3))
        k = k / k.norm(dim=-1, keepdim=True).clamp(min=1e-6)
        w = 0.7 + 0.3 * torch.rand((B, S, H, dh), generator=gen, device=dev)
        beta = torch.rand((B, S, H), generator=gen, device=dev)
        cache = 0.1 * torch.randn((3, B, H, dh, dh), generator=gen,
                                  device=dev)
        state, kept = cache[1], cache.clone()
        y, sf = wkv(r, k, v, w, beta, state)
        require(torch.equal(cache, kept),
                f"wkv {what}: the state's cache view was written")
        y_ref, sf_ref = wkv_reference(r, k, v, w, beta, state)
        err = max(max_err(y, y_ref, 1e-4, 1e-3, f"wkv {what} y"),
                  max_err(sf, sf_ref, 1e-4, 1e-3, f"wkv {what} state"))
        ms, wrapper_ms = kernel_ms(lambda: wkv(r, k, v, w, beta, state),
                                   reps=20)
        plain_ms = cuda_ms(lambda: wkv_reference(r, k, v, w, beta, state),
                           reps=1, warmup=0)
        b_ms, b_by = _wkv_bound(B, S, H, dh)
        out[what] = dict(shape=f"B={B} S={S} H={H} dh={dh}", max_abs_err=err,
                         ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by)
        log(f"  wkv {what} [{out[what]['shape']}, state in]: max_abs_err "
            f"{err:.3g}, ms {ms:.4f} (wrapper {wrapper_ms:.4f}), plain_ms "
            f"{plain_ms:.4f}, bound_ms {b_ms:.5f} ({b_by})")
        del r, k, v, w, beta, cache, state, kept, y, sf, y_ref, sf_ref
    return out


def _cache_bytes(cfg, slots: int, max_seq: int) -> int:
    """Bytes of the decode cache a ServeEngine holds (from shapes)."""
    from repro_torch.models.transformer import init_cache
    cache = init_cache(cfg, slots, max_seq, torch.float32, device="meta")
    return sum(t.numel() * t.element_size() for leaves in cache.values()
               for t in leaves.values())


def _fill_cross(params, cfg, cache, mem) -> None:
    """Writes each decoder layer's cross caches from the encoder's output
    `mem` (B, T, d), as tests/test_models.py fills JAX's: mem @ cross.wk
    and mem @ cross.wv (no bias) at the start of the enc_len axis. The
    reference never fills them itself."""
    from repro_torch.models.transformer import period_of
    B, T = mem.shape[:2]
    period = period_of(cfg)
    with torch.no_grad():
        for i, block in enumerate(params.layers):
            leaves = cache[f"p{i % period}"]
            for key, w in (("ck", block.cross.wk), ("cv", block.cross.wv)):
                value = (mem @ w.to(mem.dtype)).view(B, T, cfg.num_kv_heads,
                                                     -1)
                leaves[key][i // period, :, :T] = value.to(leaves[key].dtype)


def _cpu_vs_card(model, params, inputs, dev, atol, rtol, what,
                 wkv_per_call: int = 0) -> float:
    """`Model.prefill`'s hidden states for each batch of `inputs` (dicts
    with "tokens" and any "frames" or "patches"), then 4 decode steps over
    the first batch's tokens from a zero cache, its cross part (an
    encoder-decoder's) filled from the encoder over the first batch's
    frames (logits, every cache leaf), on the CPU and then on the card
    (the same seeded LM moved there); the card's wkv launches must be
    `wkv_per_call` a call. Returns the max abs error."""
    from repro_torch.kernels.wkv import wkv
    from repro_torch.models.transformer import encoder_apply
    first = inputs[0]
    tokens = first["tokens"]
    enc_len = first["frames"].shape[1] if "frames" in first else None
    runs = []
    for d in ("cpu", dev):
        params = params.to(d)
        t = time.perf_counter()
        before = wkv.launches
        hidden = [model.prefill(params, x)[0].cpu() for x in inputs]
        cache = model.init_cache(tokens.shape[0], 64, torch.float32,
                                 device=d, enc_len=enc_len)
        if enc_len:
            with torch.no_grad():
                mem = encoder_apply(params, model.cfg, torch.as_tensor(
                    first["frames"], device=d))
            _fill_cross(params, model.cfg, cache, mem)
            del mem
        logits = []
        for i in range(4):
            lg, cache = model.decode_step(params, cache,
                                          tokens[:, i:i + 1], i)
            logits.append(lg.cpu())
        sync(d)
        calls = len(inputs) + 4
        if torch.device(d).type == "cuda":
            require(wkv.launches - before == wkv_per_call * calls,
                    f"{what}: {wkv.launches - before} wkv launches in "
                    f"{calls} calls, not {wkv_per_call} a call")
        runs.append((hidden, torch.cat(logits, 1),
                     {n: {k: v.cpu() for k, v in lv.items()}
                      for n, lv in cache.items()}))
        log(f"  {what} on {d}: {len(inputs)} prefill(s) and 4 decode steps "
            f"in {time.perf_counter() - t:.1f} s")
    (h_cpu, l_cpu, c_cpu), (h_dev, l_dev, c_dev) = runs
    err = 0.0
    for i, (a, b) in enumerate(zip(h_dev, h_cpu)):
        require(bool(torch.isfinite(a).all()), f"{what}: non-finite hidden")
        err = max(err, max_err(a, b, atol, rtol, f"{what} hidden {i}"))
    err = max(err, max_err(l_dev, l_cpu, atol, rtol, f"{what} logits"))
    for name, leaves in c_cpu.items():
        for key, leaf in leaves.items():
            err = max(err, max_err(c_dev[name][key], leaf, atol, rtol,
                                   f"{what} cache {name}/{key}"))
    return err


def cross_check_encoder(dev) -> None:
    """(7b) semanticbbv-encoder at full width and depth (fp32) from one
    seeded LM: prefill of 2 x 256 tokens and 4 decode steps on the CPU and
    on the card, 12 wkv launches a call there."""
    from repro_torch.config import get_arch
    from repro_torch.models.model_zoo import build_model
    cfg = get_arch(ENCODER_ARCH)
    model = build_model(cfg)
    tokens = np.random.RandomState(SEED).randint(0, cfg.vocab_size, (2, 256))
    err = _cpu_vs_card(model, model.init(SEED, device="cpu"),
                       [{"tokens": tokens}], dev, 1e-4, 1e-4, cfg.name,
                       wkv_per_call=cfg.num_layers)
    log(f"  {cfg.name} fp32, CPU plain vs card kernels: max abs err "
        f"{err:.3g} (hidden, logits, caches; atol 1e-4 rtol 1e-4)")


def cross_check_xlstm(dev) -> None:
    """(7c) xlstm-1.3b at full width in fp32 on one period (8 layers, 7
    mLSTM + 1 sLSTM: the CPU half of 48 layers would take minutes) from
    one seeded LM, CPU against the card: prefill of 2 x 64 and 2 x 37
    tokens (both the chunkwise form: at the model's chunk, 256, S 37 is
    one chunk of 37) and 4 decode steps; then its first mLSTM layer at
    chunk 16 on S 37, which takes the token scan."""
    from repro_torch.config import get_arch
    from repro_torch.models import ssm
    from repro_torch.models.model_zoo import build_model
    full = get_arch(XLSTM_ARCH)
    cfg = dataclasses.replace(full, num_layers=8,
                              block_pattern=full.block_pattern[:8],
                              dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    rng = np.random.RandomState(SEED)
    inputs = [{"tokens": rng.randint(0, cfg.vocab_size, (2, S))}
              for S in (64, 37)]
    params = model.init(SEED, device="cpu")
    err = _cpu_vs_card(model, params, inputs, dev, 1e-4, 1e-3,
                       f"{cfg.name} (one period)")
    mixer = params.layers[0].mixer
    x = torch.from_numpy(rng.randn(2, 37, cfg.d_model).astype(np.float32))
    got = []
    for d in ("cpu", dev):
        mixer = mixer.to(d)
        with torch.inference_mode():
            got.append(ssm.mlstm_apply(mixer, x.to(d), cfg.num_heads,
                                       chunk=16).cpu())
    err = max(err, max_err(got[1], got[0], 1e-4, 1e-3,
                           "mLSTM token scan (S 37, chunk 16)"))
    log(f"  {cfg.name} fp32 (8 layers), CPU plain vs card: max abs err "
        f"{err:.3g} (hidden, logits, caches, the token scan; atol 1e-4 "
        f"rtol 1e-3)")


def cross_check_mamba(dev) -> None:
    """(7d) One Mamba mixer at jamba-1.5-large's width (fp32, seeded):
    `mamba_apply` on 1 x 64 and 4 `mamba_decode` steps from a zero state,
    CPU against the card; the steps equal the prefill's first 4 tokens."""
    from repro_torch.models import ssm
    d, ds, k = MAMBA_WIDTH
    mixer = ssm.Mamba(torch.Generator().manual_seed(SEED), d, ds, k,
                      torch.float32)
    x = torch.from_numpy(np.random.RandomState(SEED).randn(1, 64, d).astype(
        np.float32))
    runs = []
    for dv in ("cpu", dev):
        t = time.perf_counter()
        mixer = mixer.to(dv)
        xd = x.to(dv)
        with torch.inference_mode():
            y = ssm.mamba_apply(mixer, xd, ds)
            state = ssm.mamba_init_state(1, d, ds, k, device=dv)
            steps = []
            for i in range(4):
                yi, state = ssm.mamba_decode(mixer, xd[:, i:i + 1], state, ds)
                steps.append(yi)
        sync(dv)
        runs.append((y.cpu(), torch.cat(steps, 1).cpu(), state["ssm"].cpu(),
                     state["conv"].cpu()))
        max_err(runs[-1][1], runs[-1][0][:, :4], 1e-4, 1e-3,
                f"mamba on {dv}: decode steps vs the prefill's first tokens")
        log(f"  mamba d_model {d} on {dv}: apply 1 x 64 and 4 decode steps "
            f"in {time.perf_counter() - t:.1f} s")
    err = max(max_err(a, b, 1e-4, 1e-3, f"mamba {name}") for name, a, b in
              zip(("apply", "decode", "ssm state", "conv state"), runs[1],
                  runs[0]))
    log(f"  mamba (jamba-1.5-large width, fp32), CPU plain vs card: max abs "
        f"err {err:.3g} (atol 1e-4 rtol 1e-3)")


def _rnn_serve(arch, cfg, model, params, dev, rng) -> None:
    """(7b, 7c) `Model.prefill` of RNN_PREFILL[arch] tokens (2 calls), then
    a ServeEngine answering RNN_SERVE[arch]'s requests twice with the
    same tokens; RWKV layers launch wkv once a layer a call. Prints wall
    times, tokens/s, steps/s, peak memory and the state cache's bytes."""
    from repro_torch.kernels.wkv import wkv
    n_wkv = sum(kind == "rwkv" for kind in cfg.blocks())
    B, S = RNN_PREFILL[arch]
    V = cfg.vocab_size
    tokens = torch.from_numpy(rng.randint(0, V, (B, S))).to(dev)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for call in range(2):
        before = wkv.launches
        t = time.perf_counter()
        hidden, _ = model.prefill(params, {"tokens": tokens})
        sync(dev)
        walls.append(time.perf_counter() - t)
        require(wkv.launches - before == n_wkv,
                f"{cfg.name} prefill call {call}: {wkv.launches - before} "
                f"wkv launches, not {n_wkv}")
    require(tuple(hidden.shape) == (B, S, cfg.d_model)
            and bool(torch.isfinite(hidden).all()),
            f"{cfg.name} prefill hidden {tuple(hidden.shape)}, or not finite")
    log(f"  {cfg.name} prefill {B} x {S}: wall {1e3 * walls[1]:.2f} ms "
        f"(second call; first {1e3 * walls[0]:.2f} ms), "
        f"{B * S / walls[1]:.0f} tokens/s, {n_wkv} wkv launches a call; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del hidden, tokens

    n_req, lo, hi, new, slots, max_seq = RNN_SERVE[arch]
    lens = rng.randint(lo, hi + 1, size=n_req)
    prompts = [rng.randint(0, V, n).tolist() for n in lens]
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        before = wkv.launches
        runs.append(_serve(model, params, prompts, dev, new, slots, max_seq))
        require(wkv.launches - before == n_wkv * runs[-1][1],
                f"{cfg.name} serve: {wkv.launches - before} wkv launches in "
                f"{runs[-1][1]} decode steps, not {n_wkv} a step")
    outs, steps, serve_s = runs[0]
    require(sorted(outs) == list(range(n_req)),
            f"{cfg.name}: {len(outs)} of {n_req} requests completed")
    for r, out in outs.items():
        require(len(out) == new and all(0 <= x < V for x in out),
                f"{cfg.name} request {r}: {len(out)} tokens, or out of vocab")
    require(runs[1][0] == outs, f"{cfg.name}: the repeat gave other tokens")
    log(f"  {cfg.name} serve: {n_req} requests (prompts {lens.min()}-"
        f"{lens.max()} tokens, {new} new each) on {slots} slots, max_seq "
        f"{max_seq}: {steps} decode steps (prefill steps included) in "
        f"{serve_s:.3f} s and {runs[1][2]:.3f} s, {steps / serve_s:.1f} and "
        f"{runs[1][1] / runs[1][2]:.1f} steps/s, "
        f"{n_req * new / serve_s:.1f} new tokens/s; state cache "
        f"{_cache_bytes(cfg, slots, max_seq) / 2**30:.3f} GiB; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; the "
        f"repeat gave the same tokens")


def recurrent_zoo_path(dev) -> None:
    """(7b, 7c) The recurrent zoo's serving path on the card at full width
    and depth, seeded untrained weights: semanticbbv-encoder (fp32), then
    xlstm-1.3b (bf16)."""
    from repro_torch.config import get_arch
    from repro_torch.models.model_zoo import build_model
    rng = np.random.RandomState(SEED)
    for arch in (ENCODER_ARCH, XLSTM_ARCH):
        cfg = get_arch(arch)
        model = build_model(cfg)
        t = time.perf_counter()
        params = model.init(SEED, device=dev)
        sync(dev)
        log(f"  {cfg.name}: {model.param_count()} parameters "
            f"({cfg.param_dtype}), {cfg.num_layers} layers, drawn and moved "
            f"in {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        _rnn_serve(arch, cfg, model, params, dev, rng)
        log(f"  {cfg.name} path: {time.perf_counter() - t:.1f} s")
        del params


# ---------------------------------------------------------------- phase 8

def check_flash_moe(dev, gen) -> dict:
    """(8a) The bf16 flash kernel at qwen3-moe's prefill shape (head dim
    128, 64 query heads over 4 kv heads) against its plain version, at
    phase 6's bf16 bound; its device time (CUDA graph) beside SDPA's and
    the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        attention_reference, flash_attention,
    )
    B, S, H, K, D = MOE_FLASH_SHAPE
    q = torch.randn((B, S, H, D), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((B, S, K, D), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    shape = f"B={B} S={S} H={H} K={K} D={D} bf16 causal"
    err = max_err(flash_attention(q, k, v).float(),
                  attention_reference(q, k, v).float(), 3e-2, 1e-2,
                  f"flash [{shape}]")
    ms, wrapper_ms = kernel_ms(lambda: flash_attention(q, k, v), reps=20)
    plain_ms = cuda_ms(lambda: attention_reference(q, k, v), reps=2,
                       warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=20)
    b_ms, b_by = _flash_bound(B, S, S, H, K, D, True, 0)
    out = dict(shape=shape, max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
               bound_by=b_by)
    log(f"  flash_attention [{shape}]: max_abs_err {err:.3g}, ms {ms:.4f} "
        f"(wrapper {wrapper_ms:.4f}), plain_ms {plain_ms:.4f}, library_ms "
        f"{library_ms:.4f} (SDPA), bound_ms {b_ms:.4f} ({b_by})")
    return out


def _routing_first(cpu_routes, card_routes, what) -> torch.Tensor:
    """Holds the card's routing of each MoE call to the CPU's: top-k
    experts, slots and kept pairs equal but for flips at near ties
    (`moe.compare_routing`, ROUTING_ULPS) and the slots they move. Returns
    the groups (G,) with no difference in any call; prints the flips."""
    from repro_torch.models import moe
    require(len(cpu_routes) == len(card_routes) > 0,
            f"{what}: {len(cpu_routes)} vs {len(card_routes)} MoE calls")
    clean, flips, near = None, 0, 0
    for a, b in zip(cpu_routes, card_routes):
        cmp = moe.compare_routing(a, b, ROUTING_ULPS)
        require(cmp["n_unexplained"] == 0,
                f"{what}: {cmp['n_unexplained']} routing differences at "
                f"tokens that are no near tie")
        flips += cmp["n_flips"]
        near += cmp["n_near_ties"]
        c = cmp["clean_groups"]
        clean = c if clean is None else clean & c
    log(f"  {what} routing: {len(cpu_routes)} MoE calls, {flips} flips at "
        f"near ties ({near} tokens within {ROUTING_ULPS} ulps), "
        f"{int(clean.sum())} of {clean.numel()} groups compared further")
    return clean


def _moe_cpu_vs_card(model, params, tokens, dev):
    """(8b) qwen3-moe cut in depth (fp32): `Model.prefill` of `tokens`, its
    logits, and 4 decode steps from a zero cache on the CPU, then on the
    card (the same LM moved there); routing first, then hidden states,
    logits and caches at the zoo's fp32 bound on the groups without a
    flip. Returns the max abs error."""
    from repro_torch.models.layers import unembed
    from repro_torch.models.moe import record_routing
    runs = []
    for d in ("cpu", dev):
        params = params.to(d)
        t = time.perf_counter()
        with torch.inference_mode(), record_routing(params) as pre:
            hidden, aux = model.prefill(params, {"tokens": tokens})
            logits = unembed(params.head_table, hidden)
        cache = model.init_cache(tokens.shape[0], 64, torch.float32,
                                 device=d)
        steps = []
        with record_routing(params) as dec:
            for i in range(4):
                lg, cache = model.decode_step(params, cache,
                                              tokens[:, i:i + 1], i)
                steps.append(lg.cpu())
        sync(d)
        runs.append(dict(hidden=hidden.cpu(), logits=logits.cpu(),
                         aux=float(aux), routes=pre + dec, steps=steps,
                         cache={(n, k): v.cpu() for n, lv in cache.items()
                                for k, v in lv.items()}))
        log(f"  {model.cfg.name} ({model.cfg.num_layers} layer) on {d}: "
            f"prefill {tuple(tokens.shape)}, logits and 4 decode steps in "
            f"{time.perf_counter() - t:.1f} s")
        del hidden, logits, cache
    cpu, card = runs
    n = model.cfg.num_layers
    clean = _routing_first(cpu["routes"][:n], card["routes"][:n],
                           f"{model.cfg.name} prefill")
    g = cpu["routes"][0].idx.shape[1]
    d = model.cfg.d_model
    err = 0.0
    for key, width in (("hidden", d), ("logits", model.cfg.vocab_size)):
        a = card[key].reshape(-1, g, width)[clean]
        b = cpu[key].reshape(-1, g, width)[clean]
        require(bool(torch.isfinite(a).all()), f"non-finite {key}")
        err = max(err, max_err(a, b, 1e-4, 1e-3, f"{model.cfg.name} {key}"))
    if bool(clean.all()):
        require(abs(card["aux"] - cpu["aux"]) <= 1e-5 * abs(cpu["aux"]),
                f"aux {card['aux']} vs {cpu['aux']}")
    flipped = False
    for i in range(4):
        step = _routing_first(cpu["routes"][n * (i + 1):n * (i + 2)],
                              card["routes"][n * (i + 1):n * (i + 2)],
                              f"{model.cfg.name} decode step {i}")
        flipped = flipped or not bool(step.all())
        if flipped:
            break
        err = max(err, max_err(card["steps"][i], cpu["steps"][i], 1e-4, 1e-3,
                               f"{model.cfg.name} decode step {i} logits"))
    if not flipped:
        for key, leaf in cpu["cache"].items():
            err = max(err, max_err(card["cache"][key], leaf, 1e-4, 1e-3,
                                   f"{model.cfg.name} cache {key}"))
    log(f"  {model.cfg.name} aux: CPU {cpu['aux']:.8f}, card "
        f"{card['aux']:.8f}")
    return err


def _mixer_cpu_vs_card(mixer, cfg, x, dev):
    """(8b) One MoE mixer at full width (fp32): `moe_apply` on x and on 4
    one-token steps x[:, i], CPU then card; routing first, then the
    outputs on the groups without a flip. JAX's fan-in rule takes E for
    the expert leaves (1/sqrt(8) for grok-1), so on unit inputs the
    outputs are of order 1e4: they are held at the zoo's fp32 bound with
    its atol taken relative to the largest output, atol 1e-4 x
    max|out|, rtol 1e-3. Returns the max abs error over that scale."""
    from repro_torch.models.moe import record_routing
    kw = dict(top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor)
    runs = []
    for d in ("cpu", dev):
        mixer = mixer.to(d)
        xd = x.to(d)
        t = time.perf_counter()
        with torch.inference_mode(), record_routing(mixer) as routes:
            out, aux = mixer(xd, **kw)
            steps = [mixer(xd[:, i:i + 1], **kw)[0].cpu() for i in range(4)]
        sync(d)
        runs.append((out.cpu(), float(aux), steps, routes))
        log(f"  {cfg.name} MoE mixer on {d}: {tuple(x.shape)} and 4 steps "
            f"in {time.perf_counter() - t:.1f} s")
        del out, xd
    (o_cpu, a_cpu, s_cpu, r_cpu), (o_dev, a_dev, s_dev, r_dev) = runs
    clean = _routing_first(r_cpu[:1], r_dev[:1], f"{cfg.name} mixer")
    g = r_cpu[0].idx.shape[1]
    scale = o_cpu.abs().max().item()
    log(f"  {cfg.name} mixer outputs: max |out| {scale:.6g} on the CPU")
    err = max_err(o_dev.reshape(-1, g, cfg.d_model)[clean],
                  o_cpu.reshape(-1, g, cfg.d_model)[clean], 1e-4 * scale,
                  1e-3, f"{cfg.name} mixer output")
    if bool(clean.all()):
        require(abs(a_dev - a_cpu) <= 1e-5 * abs(a_cpu),
                f"{cfg.name} aux {a_dev} vs {a_cpu}")
    for i in range(4):
        if bool(_routing_first(r_cpu[i + 1:i + 2], r_dev[i + 1:i + 2],
                               f"{cfg.name} mixer step {i}").all()):
            err = max(err, max_err(s_dev[i], s_cpu[i], 1e-4 * scale, 1e-3,
                                   f"{cfg.name} mixer step {i}"))
    return err / scale


def cross_check_moe(dev) -> None:
    """(8b) CPU against the card in fp32 at full width, cut in depth:
    qwen3-moe-235b-a22b with 1 of its 94 layers (embedding and head
    included), then grok-1's MoE mixer alone; each is drawn once, run on
    the CPU, moved to the card, run there, and freed before the next."""
    from repro_torch.config import get_arch
    from repro_torch.models.moe import MoE
    from repro_torch.models.model_zoo import build_model
    rng = np.random.RandomState(SEED)
    B, S = MOE_CHECK_TOKENS
    cfg = dataclasses.replace(get_arch(MOE_ARCH), num_layers=1,
                              dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    t = time.perf_counter()
    params = model.init(SEED, device="cpu")
    log(f"  {cfg.name}, 1 layer, fp32: {model.param_count()} parameters "
        f"drawn in {time.perf_counter() - t:.1f} s")
    tokens = rng.randint(0, cfg.vocab_size, (B, S))
    err = _moe_cpu_vs_card(model, params, tokens, dev)
    del params
    gc.collect()
    log(f"  {cfg.name} (1 layer, fp32), CPU plain vs card: max abs err "
        f"{err:.3g} (hidden, logits, caches; atol 1e-4 rtol 1e-3)")

    gcfg = get_arch(GROK_ARCH)
    t = time.perf_counter()
    mixer = MoE(torch.Generator().manual_seed(SEED), gcfg.d_model,
                gcfg.moe.d_ff, gcfg.moe.num_experts, torch.float32,
                gated=gcfg.mlp_gated)
    log(f"  {gcfg.name} MoE mixer, fp32: "
        f"{sum(p.numel() for p in mixer.parameters())} parameters drawn in "
        f"{time.perf_counter() - t:.1f} s")
    x = torch.from_numpy(rng.randn(B, S, gcfg.d_model).astype(np.float32))
    err = _mixer_cpu_vs_card(mixer, gcfg, x, dev)
    del mixer
    gc.collect()
    log(f"  {gcfg.name} MoE mixer (fp32), CPU plain vs card: max abs err "
        f"{err:.3g} of max |out| (atol 1e-4 x max |out|, rtol 1e-3)")


def moe_zoo_path(dev) -> None:
    """(8c) qwen3-moe-235b-a22b at full width, MOE_LAYERS of its 94 layers,
    bf16, seeded: `Model.prefill` of MOE_PREFILL tokens (3 calls, exactly
    one flash launch an attention layer each, a finite positive aux), then
    a ServeEngine answering MOE_SERVE's requests twice with the same
    tokens."""
    from repro_torch.config import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model_zoo import build_model
    full = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS)
    model = build_model(cfg)
    log(f"  reduced: {json.dumps({'num_layers': [full.num_layers, MOE_LAYERS]})}")
    gc.collect()
    t = time.perf_counter()
    params = model.init(SEED, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t
    n_params, n_active = model.param_count(), model.active_param_count()
    require(n_params == MOE_PARAMS, f"{n_params} parameters")
    log(f"  {cfg.name}: {n_params} parameters ({n_active} active a token, "
        f"{cfg.param_dtype}), {cfg.num_layers} layers, drawn and moved in "
        f"{init_s:.1f} s; weights on the card "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    rng = np.random.RandomState(SEED)
    B, S = MOE_PREFILL
    V = cfg.vocab_size
    tokens = torch.from_numpy(rng.randint(0, V, (B, S))).to(dev)
    n_attn = sum(kind == "attn" for kind in cfg.blocks())
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for call in range(3):
        before = flash_attention.launches
        t = time.perf_counter()
        hidden, aux = model.prefill(params, {"tokens": tokens})
        sync(dev)
        walls.append(time.perf_counter() - t)
        require(flash_attention.launches - before == n_attn,
                f"prefill call {call}: {flash_attention.launches - before} "
                f"flash launches, not {n_attn}")
    require(tuple(hidden.shape) == (B, S, cfg.d_model)
            and hidden.dtype == torch.bfloat16
            and bool(torch.isfinite(hidden).all())
            and bool(torch.isfinite(aux)) and float(aux) > 0,
            f"prefill hidden {tuple(hidden.shape)} {hidden.dtype}, aux "
            f"{float(aux)}")
    wall = float(np.median(walls[1:]))
    log(f"  prefill {B} x {S}: wall {1e3 * wall:.2f} ms (median of calls "
        f"2-3; first {1e3 * walls[0]:.2f} ms), {B * S / wall:.0f} tokens/s, "
        f"{n_attn} flash launches a call, aux {float(aux):.6f}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del hidden, tokens

    n_req, lo, hi, new, slots, max_seq = MOE_SERVE
    lens = rng.randint(lo, hi + 1, size=n_req)
    prompts = [rng.randint(0, V, n).tolist() for n in lens]
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    runs = [_serve(model, params, prompts, dev, new, slots, max_seq)
            for _ in range(2)]
    outs, steps, serve_s = runs[0]
    require(sorted(outs) == list(range(n_req)),
            f"{len(outs)} of {n_req} requests completed")
    for r, out in outs.items():
        require(len(out) == new and all(0 <= x < V for x in out),
                f"request {r}: {len(out)} tokens, or out of vocab")
    require(runs[1][0] == outs, "the repeated run gave other tokens")
    log(f"  serve: {n_req} requests (prompts {lens.min()}-{lens.max()} "
        f"tokens, {new} new each) on {slots} slots, max_seq {max_seq}: "
        f"{steps} decode steps (prefill steps included) in {serve_s:.3f} s "
        f"and {runs[1][2]:.3f} s, {steps / serve_s:.1f} and "
        f"{runs[1][1] / runs[1][2]:.1f} steps/s, {n_req * new / serve_s:.1f} "
        f"new tokens/s; KV cache {_cache_bytes(cfg, slots, max_seq)} bytes; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB; the repeat gave the same tokens")
    del params


def moe_phase(dev, gen, drive) -> dict:
    """Phase 8: (a) flash at qwen3-moe's prefill shape, (b) CPU against
    the card at full width cut in depth, (c) qwen3-moe's serving path
    (`drive`n as "zoo_moe"; only its launches count). Returns 8a's
    numbers."""
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    flash_moe = check_flash_moe(dev, gen)
    cross_check_moe(dev)
    drive("zoo_moe", lambda: moe_zoo_path(dev))
    log(f"MoE zoo phase: {time.perf_counter() - t:.3f} s")
    return flash_moe


# ---------------------------------------------------------------- phase 9

def check_flash_modal(dev, gen) -> list:
    """(9a) prefix_len 0 bitwise the causal call at every head-dim
    instance of both kernels, the instances' resources, then the bf16
    kernel at the four shapes of the modal archs' prefills against its
    plain version (`flash_err`), its device time (CUDA graph) beside the
    plain version's, SDPA's (a boolean mask for the prefix rule) and the
    bound. The prefix cases themselves are in FLASH_CASES (6a). Returns
    the timed shapes' numbers."""
    import torch.nn.functional as F
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import (
        attention_reference, flash_attention,
    )
    bf16 = torch.bfloat16
    for D in (64, 128, 256):
        for dtype in (bf16, torch.float32):
            q, k, v = _flash_inputs(gen, dev, 2, 700, 700, 8, 2, D, dtype)
            require(torch.equal(flash_attention(q, k, v, prefix_len=0),
                                flash_attention(q, k, v)),
                    f"flash D {D} {dtype}: prefix_len 0 is not bitwise the "
                    f"causal call")
    log("  flash prefix_len 0: bitwise the causal call at D 64, 128, 256, "
        "bf16 and fp32")
    for bf in (1, 0):
        for D in (64, 128, 256):
            for prefix in (0, 1):
                a = _lib.kernel_attributes("rt_flash_attention_attributes",
                                           bf, D, prefix, 0)
                log(f"  flash_attention "
                    f"{'bf16 (wgmma)' if bf else 'fp32 (FMA)'} "
                    f"{'prefix' if prefix else 'causal/full'} instance for "
                    f"D <= {D}: {describe(a)}")
    sass = sass_counts(str(_lib.build_library()), "flash_wgmma_kernel")
    log(f"  HGMMA in the bf16 kernel's SASS: "
        f"{'not checked' if sass is None else sass['HGMMA*']}")

    out = []
    for name, (B, S, T, H, K, D), causal, P in FLASH_MODAL_SHAPES:
        q, k, v = _flash_inputs(gen, dev, B, S, T, H, K, D, bf16)
        kw = dict(causal=causal, prefix_len=P)
        err = flash_err(flash_attention(q, k, v, **kw).float(),
                        attention_reference(q, k, v, **kw).float(), False,
                        f"flash [{name}]")
        ms, wrapper_ms = kernel_ms(lambda: flash_attention(q, k, v, **kw),
                                   reps=20)
        plain_ms = cuda_ms(lambda: attention_reference(q, k, v, **kw),
                           reps=2, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if P:
            pos_q = torch.arange(S, device=dev)[:, None]
            pos_k = torch.arange(T, device=dev)[None, :]
            mask = (pos_k <= pos_q) | (pos_k < P)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and not P,
            enable_gqa=True), reps=20)
        b_ms, b_by = _flash_bound(B, S, T, H, K, D, causal, P)
        shape = (f"B={B} S={S} T={T} H={H} K={K} D={D} bf16 "
                 + ("full" if not causal else
                    f"prefix {P}" if P else "causal"))
        out.append(dict(name=name, shape=shape, max_abs_err=err, ms=ms,
                        wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=b_ms, bound_by=b_by))
        log(f"  flash_attention {name} [{shape}]: max_abs_err {err:.3g}, ms "
            f"{ms:.4f} (wrapper {wrapper_ms:.4f}), plain_ms {plain_ms:.4f}, "
            f"library_ms {library_ms:.4f} (SDPA), bound_ms {b_ms:.4f} "
            f"({b_by})")
        del q, k, v, qt, kt, vt, mask
    return out


def cross_check_modal(dev) -> None:
    """(9b) whisper-tiny at full width and depth and paligemma-3b at full
    width cut to PALI_CHECK_LAYERS layers, fp32, from one seeded LM each,
    on the CPU and on the card (`_cpu_vs_card`, whisper's cross caches
    filled from its encoder)."""
    from repro_torch.config import get_arch
    from repro_torch.models.model_zoo import build_model
    rng = np.random.RandomState(SEED)
    fp32 = dict(dtype="float32", param_dtype="float32")
    cfg = dataclasses.replace(get_arch(WHISPER_ARCH), **fp32)
    B, T, S = WHISPER_CHECK
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)),
             "frames": rng.randn(B, T, cfg.d_model).astype(np.float32)}
    model = build_model(cfg)
    err = _cpu_vs_card(model, model.init(SEED, device="cpu"), [batch], dev,
                       1e-4, 1e-3, cfg.name)
    log(f"  {cfg.name} fp32 ({B} x {T} frames, {B} x {S} tokens; cross "
        f"caches filled), CPU plain vs card kernels: max abs err {err:.3g} "
        f"(hidden, logits, caches; atol 1e-4 rtol 1e-3)")
    full = get_arch(PALI_ARCH)
    cfg = dataclasses.replace(full, num_layers=PALI_CHECK_LAYERS, **fp32)
    B, P, S = PALI_CHECK
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)),
             "patches": rng.randn(B, P, cfg.d_model).astype(np.float32)}
    model = build_model(cfg)
    t = time.perf_counter()
    params = model.init(SEED, device="cpu")
    log(f"  {cfg.name} at {cfg.num_layers} of {full.num_layers} layers "
        f"({model.param_count()} fp32 parameters) drawn in "
        f"{time.perf_counter() - t:.1f} s")
    err = _cpu_vs_card(model, params, [batch], dev, 1e-4, 1e-3, cfg.name)
    log(f"  {cfg.name} fp32 ({B} x ({P} patches + {S} tokens)), CPU plain "
        f"vs card kernels: max abs err {err:.3g} (hidden, logits, caches; "
        f"atol 1e-4 rtol 1e-3)")
    del params


def _modal_path(arch, n_params, batch_of, rows, serve, dev) -> None:
    """(9c, 9d) `arch` at full width and depth in bf16, seeded: 3
    `Model.prefill` calls over `batch_of(cfg, rng)` (exactly one flash
    launch a decoder layer and, for an encoder-decoder, one an encoder
    layer and one a cross-attention), hidden (B, rows, d); then a
    ServeEngine answering `serve`'s requests twice with the same
    tokens."""
    from repro_torch.config import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model_zoo import build_model
    cfg = get_arch(arch)
    model = build_model(cfg)
    gc.collect()
    t = time.perf_counter()
    params = model.init(SEED, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t
    require(model.param_count() == n_params,
            f"{cfg.name}: {model.param_count()} parameters, not {n_params}")
    log(f"  {cfg.name}: {n_params} parameters ({cfg.param_dtype}), "
        f"{cfg.encoder_layers} encoder + {cfg.num_layers} decoder layers, "
        f"drawn and moved in {init_s:.1f} s; weights on the card "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    rng = np.random.RandomState(SEED)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in batch_of(cfg, rng).items()}
    B = batch["tokens"].shape[0]
    per_call = cfg.num_layers * (2 if cfg.cross_attention else 1) \
        + cfg.encoder_layers
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for call in range(3):
        before = flash_attention.launches
        t = time.perf_counter()
        hidden, aux = model.prefill(params, batch)
        sync(dev)
        walls.append(time.perf_counter() - t)
        require(flash_attention.launches - before == per_call,
                f"prefill call {call}: {flash_attention.launches - before} "
                f"flash launches, not {per_call}")
    require(tuple(hidden.shape) == (B, rows, cfg.d_model)
            and hidden.dtype == torch.bfloat16
            and bool(torch.isfinite(hidden).all()) and float(aux) == 0.0,
            f"prefill hidden {tuple(hidden.shape)} {hidden.dtype}")
    wall = float(np.median(walls[1:]))
    sizes = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
    n_in = sum(v.shape[0] * v.shape[1] for v in batch.values())
    log(f"  prefill [{sizes}]: wall {1e3 * wall:.2f} ms (median of calls "
        f"2-3; first {1e3 * walls[0]:.2f} ms), {B * rows / wall:.0f} "
        f"decoder rows/s, {n_in / wall:.0f} input positions/s, {per_call} "
        f"flash launches a call; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del hidden, batch

    n_req, lo, hi, new, slots, max_seq = serve
    V = cfg.vocab_size
    lens = rng.randint(lo, hi + 1, size=n_req)
    prompts = [rng.randint(0, V, n).tolist() for n in lens]
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    runs = [_serve(model, params, prompts, dev, new, slots, max_seq)
            for _ in range(2)]
    outs, steps, serve_s = runs[0]
    require(sorted(outs) == list(range(n_req)),
            f"{len(outs)} of {n_req} requests completed")
    for r, out in outs.items():
        require(len(out) == new and all(0 <= x < V for x in out),
                f"request {r}: {len(out)} tokens, or out of vocab")
    require(runs[1][0] == outs, "the repeated run gave other tokens")
    log(f"  serve: {n_req} requests (prompts {lens.min()}-{lens.max()} "
        f"tokens, {new} new each) on {slots} slots, max_seq {max_seq}: "
        f"{steps} decode steps (prefill steps included) in {serve_s:.3f} s "
        f"and {runs[1][2]:.3f} s, {steps / serve_s:.1f} and "
        f"{runs[1][1] / runs[1][2]:.1f} steps/s, {n_req * new / serve_s:.1f} "
        f"new tokens/s; cache {_cache_bytes(cfg, slots, max_seq)} bytes"
        f"{' (ck/cv included)' if cfg.cross_attention else ''}; peak device "
        f"memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; the repeat "
        f"gave the same tokens")
    del params


def whisper_path(dev) -> None:
    """(9c) whisper-tiny: 16 x 1500 frames and 16 x 448 tokens."""
    B, T, S = WHISPER_PREFILL
    _modal_path(WHISPER_ARCH, WHISPER_PARAMS, lambda cfg, rng: {
        "tokens": rng.randint(0, cfg.vocab_size, (B, S)),
        "frames": rng.randn(B, T, cfg.d_model).astype(np.float32)},
        S, WHISPER_SERVE, dev)


def pali_path(dev) -> None:
    """(9d) paligemma-3b: 8 x (256 patches + 1,792 tokens)."""
    B, P, S = PALI_PREFILL
    _modal_path(PALI_ARCH, PALI_PARAMS, lambda cfg, rng: {
        "tokens": rng.randint(0, cfg.vocab_size, (B, S)),
        "patches": rng.randn(B, P, cfg.d_model).astype(np.float32)},
        P + S, PALI_SERVE, dev)


def modal_launches() -> dict:
    """Flash launches each modal path must make: 3 prefill calls."""
    from repro_torch.config import get_arch
    w, p = get_arch(WHISPER_ARCH), get_arch(PALI_ARCH)
    return {"zoo_encdec": 3 * (2 * w.num_layers + w.encoder_layers),
            "zoo_vlm": 3 * p.num_layers}


def modal_phase(dev, gen, drive) -> list:
    """Phase 9: (a) flash's prefix rule and the modal archs' shapes, (b)
    CPU against the card, (c) whisper-tiny's and (d) paligemma-3b's
    serving paths (`drive`n as "zoo_encdec" and "zoo_vlm"; only their
    launches count). Returns 9a's timed shapes."""
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    shapes = check_flash_modal(dev, gen)
    cross_check_modal(dev)
    drive("zoo_encdec", lambda: whisper_path(dev))
    drive("zoo_vlm", lambda: pali_path(dev))
    log(f"modal zoo phase: {time.perf_counter() - t:.3f} s")
    return shapes


# --------------------------------------------------------------- phase 10

def _flash_bwd_bound(B, S, T, H, K, D, causal, prefix_len):
    """(bound_ms, bound_by) of one bf16 flash backward: q, k, v, o and dO
    read and dq, dk, dv written once, lse and delta (fp32, B H S each);
    10 D operations a visible (q, k) pair (S = QK^T, dP = dO V^T, dV, dK,
    dQ) at the bf16 peak."""
    nbytes = 2 * (4 * B * S * H * D + 4 * B * T * K * D) + 2 * 4 * B * H * S
    flops = 10 * D * B * H * _visible_pairs(S, T, causal, 0, prefix_len)
    return bound(nbytes, flops, PEAK_BF16_FLOP_PER_S)


def _grad_err(got, want, what: str, bf16: bool) -> float:
    """Max |got - want| of a gradient against its plain version: fp32 at
    the wkv backward's bound (atol 1e-4, rtol 1e-3); bf16 at atol 1e-2,
    rtol 1e-2 and a relative L2 error of 1e-2 (both round once from
    fp32)."""
    if not bf16:
        return max_err(got, want, 1e-4, 1e-3, what)
    return flash_err(got.float(), want.float(), False, what)


def check_flash_backward(dev, gen) -> dict:
    """(10a) The flash backward kernel against its plain version
    (`attention_backward_reference`) on the same q, k, v, o, dO and lse,
    at every row of FLASH_CASES in fp32 and bf16 (`_grad_err`), bitwise
    on a repeat; the `LSE` forward's output bitwise the flagged-off one's
    and its log-sum-exp against the plain one; fused-projection views and
    an odd offset bitwise contiguous copies; the whole autograd path
    against autograd of the plain version; the instances' resources; then
    timed at FLASH_BWD_SHAPES beside SDPA's backward and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import (
        attention_backward_reference, attention_reference, flash_attention,
        flash_attention_backward, flash_forward,
    )
    err = 0.0
    for B, S, T, H, K, D, causal, window, P, _ in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            q, k, v = _flash_inputs(gen, dev, B, S, T, H, K, D, dtype)
            do = torch.randn((B, S, H, D), generator=gen,
                             device=dev).to(dtype)
            kw = dict(causal=causal, window=window, prefix_len=P)
            case = (B, S, T, H, K, D, causal, f"window {window}",
                    f"prefix {P}", str(dtype))
            o, lse = flash_forward(q, k, v, return_lse=True, **kw)
            require(torch.equal(o, flash_forward(q, k, v, **kw)),
                    f"flash {case}: the LSE instance's output is not "
                    f"bitwise the other's")
            _, lse_ref = attention_reference(q, k, v, return_lse=True, **kw)
            max_err(lse, lse_ref, 2e-2 if bf16 else 1e-4, 1e-4,
                    f"flash lse {case}")
            got = flash_attention_backward(q, k, v, o, do, lse, **kw)
            want = attention_backward_reference(q, k, v, o, do, lse, **kw)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                require(a.dtype == dtype and bool(torch.isfinite(a).all()),
                        f"flash backward {case} {name}: dtype or non-finite")
                err = max(err, _grad_err(a, b, f"flash backward {case} "
                                         f"{name}", bf16))
            again = flash_attention_backward(q, k, v, o, do, lse, **kw)
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"flash backward {case}: two launches are not bitwise "
                    f"equal")
            del q, k, v, do, o, lse, lse_ref, got, want, again
    log(f"  flash backward at every FLASH_CASES row, fp32 and bf16: max abs "
        f"err {err:.3g}, bitwise repeats, LSE outputs bitwise")

    # the bf16 kernels' three load routes: TMA (contiguous rows and the
    # fused views), 16-byte cp.async (a head-major view: its strides do
    # not grow with its dims, so no tensor map) and element loads (odd)
    B, S, H, K, D = FLASH_VIEW_SHAPE
    qkv = torch.randn((B, S, (H + 2 * K) * D), generator=gen,
                      device=dev).bfloat16()
    q = qkv[..., :H * D].view(B, S, H, D)
    k = qkv[..., H * D:(H + K) * D].view(B, S, K, D)
    v = qkv[..., (H + K) * D:].view(B, S, K, D)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    q_odd = buf[1:].view(q.shape)
    q_odd.copy_(q)
    q_heads = q.transpose(1, 2).contiguous().transpose(1, 2)
    do = torch.randn((B, S, H, D), generator=gen, device=dev).bfloat16()
    o, lse = flash_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                           return_lse=True)
    want = flash_attention_backward(q.contiguous(), k.contiguous(),
                                    v.contiguous(), o, do, lse)
    for name, args in (("fused-projection views", (q, k, v)),
                       ("a head-major view", (q_heads, k, v)),
                       ("odd offset", (q_odd, k, v))):
        got = flash_attention_backward(*args, o, do, lse)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"flash backward {name}: not bit for bit the contiguous "
                f"copies' result")
    log("  flash backward on views of a fused projection, a head-major "
        "view and at an odd offset: bit for bit the contiguous result")
    del qkv, q, k, v, buf, q_odd, q_heads, do, o, lse, want, got

    # the autograd path (LSE forward, then the backward kernel) against
    # autograd of the plain version
    auto = {}
    for B, S, T, H, K, D, causal, P in FLASH_AUTOGRAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.requires_grad_() for t in _flash_inputs(
                gen, dev, B, S, T, H, K, D, dtype))
            do = torch.randn((B, S, H, D), generator=gen,
                             device=dev).to(dtype)
            kw = dict(causal=causal, prefix_len=P)
            before = (flash_attention.launches,
                      flash_attention_backward.launches)
            got = torch.autograd.grad(flash_attention(q, k, v, **kw),
                                      (q, k, v), do)
            require((flash_attention.launches,
                     flash_attention_backward.launches)
                    == (before[0] + 1, before[1] + 1),
                    "autograd through flash: not one forward and one "
                    "backward launch")
            want = torch.autograd.grad(attention_reference(q, k, v, **kw),
                                       (q, k, v), do)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                what = (f"flash autograd [{B}x{S}x{T} H {H} K {K} D {D} "
                        f"{'causal' if causal else 'full'} prefix {P} "
                        f"{dtype}] {name}")
                if dtype == torch.float32:
                    max_err(a, b, 1e-4, 1e-3, what)
                else:
                    rel = ((a.float() - b.float()).norm()
                           / b.float().norm()).item()
                    e = (a.float() - b.float()).abs().max().item()
                    top = max(1.0, b.float().abs().max().item())
                    auto[what] = (e, rel)
                    require(rel <= FLASH_AUTOGRAD_BF16_REL
                            and e <= FLASH_AUTOGRAD_BF16_REL * top,
                            f"{what}: max abs err {e:.3g}, relative L2 "
                            f"error {rel:.3g}")
                    log(f"  {what}: max abs err {e:.3g} (max |g| "
                        f"{b.float().abs().max().item():.3g}), relative L2 "
                        f"error {rel:.3g}")
            del q, k, v, do, got, want
    log("  flash autograd (LSE forward + backward kernel) against autograd "
        f"of the plain version: fp32 within 1e-4 + 1e-3, bf16 within a "
        f"relative L2 error of {FLASH_AUTOGRAD_BF16_REL} and "
        f"{FLASH_AUTOGRAD_BF16_REL} max(1, max|g|)")

    resources = {}
    for bf in (0, 1):
        for D in (64, 128, 256):
            for prefix in (0, 1):
                for kern, name in ((0, "delta"), (1, "dkdv"), (2, "dq")):
                    a = _lib.kernel_attributes(
                        "rt_flash_attention_backward_attributes", bf, D,
                        prefix, kern)
                    resources[(bf, D, prefix, name)] = a
                    log(f"  flash backward {'bf16' if bf else 'fp32'} "
                        f"{name} {'prefix' if prefix else 'causal/full'} "
                        f"instance for D <= {D}: {describe(a)}")
                    require(not bf or a["local_bytes"] == 0,
                            f"flash backward bf16 {name} at D <= {D}: "
                            f"{a['local_bytes']} B of spills")
            for lse in (0, 1):
                a = _lib.kernel_attributes("rt_flash_attention_attributes",
                                           bf, D, 0, lse)
                log(f"  flash forward {'bf16' if bf else 'fp32'} "
                    f"{'LSE' if lse else 'plain'} instance for D <= {D}: "
                    f"{describe(a)}")
    # the bf16 dK/dV and dQ kernels run their products on wgmma
    hgmma = {}
    for name in ("dkdv_wgmma_kernel", "dq_wgmma_kernel"):
        sass = sass_counts(str(_lib.build_library()), name)
        hgmma[name] = None if sass is None else sass["HGMMA*"]
        if hgmma[name] is None:
            log(f"  HGMMA in {name}'s SASS: not checked (no cuobjdump)")
        else:
            log(f"  HGMMA in {name}'s SASS: {hgmma[name]} instructions")
            require(hgmma[name] > 0, f"the bf16 flash backward's {name} has "
                    f"no HGMMA instruction")

    out = []
    for name, (B, S, T, H, K, D), causal, P in FLASH_BWD_SHAPES:
        q, k, v = _flash_inputs(gen, dev, B, S, T, H, K, D, torch.bfloat16)
        do = torch.randn((B, S, H, D), generator=gen, device=dev).bfloat16()
        kw = dict(causal=causal, prefix_len=P)
        o, lse = flash_forward(q, k, v, return_lse=True, **kw)
        got = flash_attention_backward(q, k, v, o, do, lse, **kw)
        e = 0.0
        for gname, a, b in zip(("dq", "dk", "dv"), got, (
                attention_backward_reference(q, k, v, o, do, lse, **kw))):
            e = max(e, _grad_err(a, b, f"flash backward [{name}] {gname}",
                                 True))
        del got
        ms, wrapper_ms = kernel_ms(lambda: flash_attention_backward(
            q, k, v, o, do, lse, **kw), reps=10)
        plain_ms = cuda_ms(lambda: attention_backward_reference(
            q, k, v, o, do, lse, **kw), reps=2, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2)
        mask = None
        if P:
            pos_q = torch.arange(S, device=dev)[:, None]
            pos_k = torch.arange(T, device=dev)[None, :]
            mask = (pos_k <= pos_q) | (pos_k < P)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and not P,
                enable_gqa=True)

        def sdpa_both():
            torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

        with torch.no_grad():
            fwd_ms = cuda_ms(sdpa, reps=10)
        library_ms = cuda_ms(sdpa_both, reps=10) - fwd_ms
        b_ms, b_by = _flash_bwd_bound(B, S, T, H, K, D, causal, P)
        shape = (f"B={B} S={S} T={T} H={H} K={K} D={D} bf16 "
                 + ("full" if not causal else
                    f"prefix {P}" if P else "causal"))
        out.append(dict(name=name, shape=shape, max_abs_err=e, ms=ms,
                        wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=b_ms, bound_by=b_by))
        log(f"  flash_attention_backward {name} [{shape}]: max_abs_err "
            f"{e:.3g}, ms {ms:.4f} (wrapper {wrapper_ms:.4f}), plain_ms "
            f"{plain_ms:.4f}, library_ms {library_ms:.4f} (SDPA backward: "
            f"forward + backward {library_ms + fwd_ms:.4f} less forward "
            f"{fwd_ms:.4f}), bound_ms {b_ms:.4f} ({b_by}), "
            f"{b_ms / ms:.3f} of the bound")
        del q, k, v, do, o, lse, qt, kt, vt, dot, mask
    first = out[0]
    dkdv = resources[(1, 64, 0, "dkdv")]
    return dict(err=max(err, max(x["max_abs_err"] for x in out)),
                ms=first["ms"], wrapper_ms=first["wrapper_ms"],
                plain_ms=first["plain_ms"], library_ms=first["library_ms"],
                bound=(first["bound_ms"], first["bound_by"]),
                shape=first["shape"],
                extra=dict(registers=dkdv["registers"],
                           local_bytes=dkdv["local_bytes"],
                           hgmma=hgmma, train_shapes=out[1:],
                           autograd_bf16=[dict(what=k, max_abs_err=v[0],
                                               rel_l2=v[1])
                                          for k, v in auto.items()]))


def _loss_grads(model, params, batch):
    """(loss, {name: gradient on the CPU}) of `Model.loss` on `batch`."""
    loss, _ = model.loss(params, batch)
    names, leaves = zip(*params.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), {n: g.cpu() for n, g in zip(names, grads)}


def cross_check_zoo_train(dev) -> None:
    """(10b) `Model.loss` and every parameter's gradient, fp32, from one
    seeded LM on the CPU and then on the card (the same module moved
    there): smollm-135m at full width and 2 layers, whisper-tiny whole
    with 1500 frames, paligemma-3b at full width and 2 layers, and the
    semanticbbv-encoder at 2 layers (the wkv kernels on the zoo's path);
    per leaf within 1e-4 max(1, max|g|)."""
    from repro_torch.config import get_arch
    from repro_torch.kernels.flash_attention import flash_attention_backward
    from repro_torch.kernels.wkv import wkv_backward
    from repro_torch.models.model_zoo import build_model
    rng = np.random.RandomState(SEED)
    fp32 = dict(dtype="float32", param_dtype="float32")
    for arch, layers, B, S, extra in LM_TRAIN_CHECKS:
        full = get_arch(arch)
        n = layers or full.num_layers
        cfg = dataclasses.replace(full, num_layers=n, **fp32, block_pattern=(
            full.block_pattern[:n] if full.block_pattern else None))
        batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, S))}
        if extra == "frames":
            batch["frames"] = rng.randn(B, 1500, cfg.d_model).astype(
                np.float32)
        elif extra == "patches":
            batch["patches"] = rng.randn(
                B, cfg.num_prefix_embeddings, cfg.d_model).astype(np.float32)
        model = build_model(cfg)
        t = time.perf_counter()
        params = model.init(SEED, device="cpu")
        loss_cpu, g_cpu = _loss_grads(model, params, batch)
        cpu_s = time.perf_counter() - t
        params = params.to(dev)
        before = (flash_attention_backward.launches, wkv_backward.launches)
        t = time.perf_counter()
        loss_dev, g_dev = _loss_grads(model, params, batch)
        sync(dev)
        dev_s = time.perf_counter() - t
        n = (flash_attention_backward.launches - before[0],
             wkv_backward.launches - before[1])
        kinds = cfg.blocks()
        want = (kinds.count("attn") * (2 if cfg.cross_attention else 1)
                + cfg.encoder_layers, kinds.count("rwkv"))
        require(n == want or torch.device(dev).type == "cpu",
                f"{arch}: flash / wkv backward launched {n}, not {want}")
        require(abs(loss_dev - loss_cpu) <= 1e-4 * max(1.0, abs(loss_cpu)),
                f"{arch}: loss {loss_dev} on the card, {loss_cpu} on the CPU")
        worst, worst_name = 0.0, ""
        for name, want in g_cpu.items():
            scale = max(1.0, float(want.abs().max()))
            e = float((g_dev[name] - want).abs().max())
            require(e <= 1e-4 * scale, f"{arch} gradient {name}: max abs "
                    f"err {e:.3g} beyond 1e-4 x {scale:.3g}")
            if e / scale > worst:
                worst, worst_name = e / scale, name
        log(f"  {cfg.name} fp32 ({cfg.num_layers} of {full.num_layers} "
            f"layers, {model.param_count()} parameters, batch "
            + ", ".join(f"{k} {tuple(np.shape(v))}" for k, v in batch.items())
            + f"): loss {loss_cpu:.6f} CPU / {loss_dev:.6f} card; "
            f"{len(g_cpu)} gradients, worst max abs err / max(1, max|g|) "
            f"{worst:.3g} ({worst_name}); flash / wkv backward launches "
            f"{n[0]} / {n[1]}; CPU {cpu_s:.1f} s, card {dev_s:.1f} s")
        del params, g_cpu, g_dev


def _lm_steps(trainer, batch_fn, steps, per_step, what, ckpt=True):
    """`steps` Trainer steps on batch_fn(step); each must give a finite
    loss and launch the flash forward and backward `per_step` = (forward,
    backward) times. Returns the step seconds."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward,
    )
    step_s = []
    for _ in range(steps):
        batch = batch_fn(trainer.state.step)
        sync(batch["tokens"].device)
        before = (flash_attention.launches, flash_attention_backward.launches)
        t = time.perf_counter()
        m = trainer.step(batch)
        sync(batch["tokens"].device)
        step_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        saved = trainer.maybe_checkpoint() if ckpt else None
        ck_s = time.perf_counter() - t
        n = (flash_attention.launches - before[0],
             flash_attention_backward.launches - before[1])
        require(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
                f"{what} step {trainer.state.step}: loss {m['loss']}")
        require(n == per_step, f"{what} step {trainer.state.step}: flash "
                f"forward/backward launched {n}, not {per_step}")
        log(f"  {what} step {trainer.state.step:2d}: loss {m['loss']:.5f} "
            f"nll {m['nll']:.5f} aux {m['aux']:.5f} grad_norm "
            f"{m['grad_norm']:.4f} lr {m['lr']:.2e} step "
            f"{1e3 * step_s[-1]:.2f} ms"
            + (f", checkpoint {1e3 * ck_s:.1f} ms" if saved else ""))
    return step_s


def lm_train_path(dev) -> dict:
    """(10c) smollm-135m at full width and depth (bf16, seeded) trained by
    `repro_torch.launch.train` (`make_run`, its Trainer and batches):
    LM_TRAIN_STEPS steps of LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens, AdamW, a
    checkpoint every 10 to build/chip_smoke_lm, exactly one flash forward
    and one backward launch a layer a step; then one step each under
    remat "full" and "dots" (two forward launches a layer, one backward)
    and 3 profiled steps. Returns what the resume witness needs."""
    from repro_torch.launch import train as launch_train
    ckdir = os.path.join(HERE, "build", "chip_smoke_lm")
    shutil.rmtree(ckdir, ignore_errors=True)
    kw = dict(preset="full", steps=LM_TRAIN_STEPS, batch=LM_TRAIN_BATCH,
              seq=LM_TRAIN_SEQ, checkpoint_every=10, device=dev)
    gc.collect()
    t = time.perf_counter()
    run = launch_train.make_run(ZOO_ARCH, checkpoint_dir=os.path.join(
        ckdir, "run"), **kw)
    cfg = run.cfg
    n_params = sum(p.numel() for p in run.trainer.model.parameters())
    require(n_params == LM_TRAIN_PARAMS, f"{n_params} smollm parameters")
    log(f"  {cfg.name}: {n_params} parameters ({cfg.param_dtype}), "
        f"{cfg.num_layers} layers, drawn and moved in "
        f"{time.perf_counter() - t:.1f} s")
    L = cfg.num_layers
    _peak_reset()
    step_s = _lm_steps(run.trainer, run.batch_fn, LM_TRAIN_STEPS, (L, L),
                       "smollm train")
    peak = torch.cuda.max_memory_allocated()
    final = {n: p.detach().clone()
             for n, p in run.trainer.state.params.items()}
    med = float(np.median(step_s[1:]))
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    log(f"  smollm train ({LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens a step, "
        f"remat none, deterministic algorithms): step median "
        f"{1e3 * med:.2f} ms (first {1e3 * step_s[0]:.2f}), "
        f"{tokens / med:.0f} tokens/s, peak device memory "
        f"{peak / 2**30:.3f} GiB (after gc.collect()), {L} flash forward "
        f"and {L} backward launches a step")
    batches = [run.batch_fn(s) for s in range(3)]
    _profile(lambda: [run.trainer.step(b) for b in batches], 3,
             f"smollm train step ({LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens",
             "flash")
    del run, batches
    for policy in ("full", "dots"):
        gc.collect()
        run = launch_train.make_run(ZOO_ARCH, remat=policy,
                                    checkpoint_dir=os.path.join(
                                        ckdir, policy), **kw)
        _lm_steps(run.trainer, run.batch_fn, 1, (2 * L, L),
                  f"remat {policy} warm-up", ckpt=False)
        _peak_reset()
        s = _lm_steps(run.trainer, run.batch_fn, 1, (2 * L, L),
                      f"remat {policy}", ckpt=False)
        log(f"  remat {policy}: step {1e3 * s[0]:.2f} ms, peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
            f"{2 * L} flash forward and {L} backward launches a step")
        del run
    return dict(kw=kw, ckdir=ckdir, final=final)


def lm_train_witness(path: dict) -> None:
    """A fresh run of `make_run`, restored from 10c's step-10 checkpoint
    (JAX's stacked layout) and trained to LM_TRAIN_STEPS, ends with
    bitwise the weights of the uninterrupted run."""
    from repro_torch.launch import train as launch_train
    resumed = os.path.join(path["ckdir"], "resumed")
    os.makedirs(resumed)
    shutil.copytree(os.path.join(path["ckdir"], "run", "step_0000000010"),
                    os.path.join(resumed, "step_0000000010"))
    gc.collect()
    t = time.perf_counter()
    run = launch_train.make_run(ZOO_ARCH, checkpoint_dir=resumed,
                                **path["kw"])
    run.trainer.fit(run.batch_fn, LM_TRAIN_STEPS, log_every=LM_TRAIN_STEPS)
    require(run.trainer.state.step == LM_TRAIN_STEPS, "the resumed run's step")
    differ = [n for n, p in path["final"].items()
              if not torch.equal(p, run.trainer.state.params[n])]
    require(not differ, f"smollm resume from step 10 is not bitwise equal: "
            f"{differ[:5]}")
    log(f"  smollm resume: {LM_TRAIN_STEPS - 10} steps from the step-10 "
        f"checkpoint in {time.perf_counter() - t:.3f} s, bitwise equal "
        f"({len(path['final'])} parameters)")
    del run


def lm_train_masks(dev) -> None:
    """(10d) bf16 training steps of the other masks: whisper-tiny whole
    with 1500 frames (encoder full, decoder causal, cross over ragged T)
    and paligemma-3b at full width and PALI_TRAIN_LAYERS layers (the
    prefix rule at D 256, 8 heads over 1); exact flash launches a step."""
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import Trainer
    for arch, layers, (B, P, S) in ((WHISPER_ARCH, 0, WHISPER_TRAIN),
                                    (PALI_ARCH, PALI_TRAIN_LAYERS,
                                     PALI_TRAIN)):
        full = get_arch(arch)
        cfg = dataclasses.replace(full, num_layers=layers or full.num_layers)
        model = build_model(cfg)
        gc.collect()
        t = time.perf_counter()
        params = model.init(SEED, device=dev)
        init_s = time.perf_counter() - t
        rng = np.random.RandomState(SEED)
        side = "frames" if cfg.encoder_layers else "patches"
        data = [{"tokens": rng.randint(0, cfg.vocab_size, (B, S)),
                 side: rng.randn(B, P, cfg.d_model).astype(np.float32)}
                for _ in range(LM_MASK_STEPS)]
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in d.items()}
                   for d in data]
        trainer = Trainer(lambda p, b: model.loss(p, b), params, TrainConfig(
            learning_rate=3e-4, total_steps=LM_MASK_STEPS, warmup_steps=2,
            checkpoint_every=0))
        per = cfg.num_layers * (2 if cfg.cross_attention else 1) \
            + cfg.encoder_layers
        _peak_reset()
        s = _lm_steps(trainer, lambda i: batches[i], LM_MASK_STEPS,
                      (per, per), cfg.name, ckpt=False)
        log(f"  {cfg.name} bf16 ({cfg.encoder_layers} + {cfg.num_layers} of "
            f"{full.num_layers} layers, {model.param_count()} parameters, "
            f"drawn in {init_s:.1f} s; {B} x ({P} {side} + {S} tokens)): "
            f"step median {1e3 * float(np.median(s[1:])):.2f} ms (first "
            f"{1e3 * s[0]:.2f}), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, {per} flash "
            f"forward and {per} backward launches a step")
        del trainer, params, batches


def lm_train_launches() -> dict:
    """Flash forward and backward launches the zoo_train path (10c, 10d)
    must make: one each an attention layer a step (smollm's main run and
    3 profiled steps; whisper's encoder, decoder and cross layers;
    paligemma's 2 layers), but two forward under remat "full" and "dots"
    (2 steps each)."""
    from repro_torch.config import get_arch
    L = get_arch(ZOO_ARCH).num_layers
    w = get_arch(WHISPER_ARCH)
    masks = LM_MASK_STEPS * (2 * w.num_layers + w.encoder_layers
                             + PALI_TRAIN_LAYERS)
    plain = L * (LM_TRAIN_STEPS + 3) + masks
    return {"flash_attention": plain + 2 * 2 * 2 * L,
            "flash_attention_backward": plain + 2 * 2 * L}


def lm_train_phase(dev, gen, drive) -> dict:
    """Phase 10: (a) the flash backward kernel, (b) CPU against the card
    for the gradients, (c) smollm-135m trained at full width (`drive`n as
    "zoo_train", with (d)), its resume witness after the path's launches
    are read, (d) whisper's and paligemma's masks in training, all under
    deterministic algorithms from (c) on. Returns 10a's numbers."""
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    r = check_flash_backward(dev, gen)
    t_a = time.perf_counter() - t
    cross_check_zoo_train(dev)
    t_b = time.perf_counter() - t - t_a
    torch.use_deterministic_algorithms(True)
    try:
        path = drive("zoo_train", lambda: (lm_train_path(dev),
                                           lm_train_masks(dev))[0])
        lm_train_witness(path)
    finally:
        torch.use_deterministic_algorithms(False)
    del path
    log(f"lm training phase: {time.perf_counter() - t:.3f} s (10a "
        f"{t_a:.1f} s, 10b {t_b:.1f} s)")
    return r


# --------------------------------------------------------------- phase 11


def _rel_l2(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def _same_bits(got, want32, what: str) -> None:
    """A bf16 instance's output against the fp32 instance's on the
    upcast inputs: bit for bit, once the fp32 output is rounded to the
    bf16 output's dtype (fp32 outputs are compared as they are)."""
    want = want32.to(got.dtype)
    if not torch.equal(got, want):
        d = (got.float() - want.float()).abs().max().item()
        raise AssertionError(f"{what}: not bitwise the fp32 instance's "
                             f"(max diff {d:.3g})")


def _bf16_attrs(entry, *shape, plan_bytes=None, what=""):
    """The bf16 instance's resources; its shared bytes against the plan."""
    from repro_torch.kernels import _lib
    a = _lib.kernel_attributes(entry, 1, *shape)
    log(f"  {what} bf16 instance: {describe(a)}")
    if plan_bytes is not None:
        got = a["dynamic_smem"] or a["static_smem"]
        require(got == plan_bytes, f"{what} bf16: shared bytes {got}, the "
                f"plan says {plan_bytes}")
    return a


def check_bf16_wkv(dev, gen) -> dict:
    """(11a) wkv's bf16 instances (bf16 r, k, v; fp32 w, beta, state):
    bitwise the fp32 instances on the upcast inputs, at the main path's
    shapes, dh 40 (16-byte route), 44 and 37 (element route) and 128, S 1;
    against the plain versions at the JAX suite's bf16 bound; timed beside
    the fp32 instances."""
    from repro_torch.kernels.wkv import (
        wkv, wkv_backward, wkv_backward_reference, wkv_reference,
    )
    from repro_torch.kernels.wkv.ops import _forward, backward_plan, kernel_plan
    bf = torch.bfloat16

    def inputs(B, S, H, dh):
        r, k, v, dy = (torch.randn((B, S, H, dh), generator=gen, device=dev)
                       for _ in range(4))
        k = k / k.norm(dim=-1, keepdim=True).clamp(min=1e-6)
        w = 0.7 + 0.3 * torch.rand((B, S, H, dh), generator=gen, device=dev)
        beta = torch.rand((B, S, H), generator=gen, device=dev)
        s0, dsf = (0.1 * torch.randn((B, H, dh, dh), generator=gen,
                                     device=dev) for _ in range(2))
        return (r.to(bf), k.to(bf), v.to(bf)), w, beta, s0, dy, dsf

    atol, rtol = BF16_KERNEL_BOUNDS["wkv"]
    err_f = err_b = 0.0
    for shape in [(256, 128, 6, 64), (3, 37, 2, 44), (2, 20, 2, 37),
                  (2, 33, 2, 40), (2, 129, 2, 128), (2, 1, 3, 64)]:
        rkv, w, beta, s0, dy, dsf = inputs(*shape)
        rkv32 = tuple(t.float() for t in rkv)
        for state in (None, s0):
            y, sf = wkv(*rkv, w, beta, state)
            y32, sf32 = wkv(*rkv32, w, beta, state)
            require(y.dtype == sf.dtype == torch.float32,
                    f"wkv bf16 {shape}: y {y.dtype}, state {sf.dtype}")
            _same_bits(y, y32, f"wkv bf16 y {shape}")
            _same_bits(sf, sf32, f"wkv bf16 state {shape}")
            y_ref, sf_ref = wkv_reference(*rkv, w, beta, state)
            err_f = max(err_f, max_err(y, y_ref, atol, rtol,
                                       f"wkv bf16 y {shape}"),
                        max_err(sf, sf_ref, atol, rtol,
                                f"wkv bf16 state {shape}"))
        y, sf, states = _forward(*rkv, w, beta, s0, save=True)
        _, _, states32 = _forward(*rkv32, w, beta, s0, save=True)
        if states is not None:      # the kernels write them, the CPU not
            _same_bits(states, states32, f"wkv bf16 states {shape}")
        out = wkv_backward(*rkv, w, beta, s0, states, dy, dsf)
        out32 = wkv_backward(*rkv32, w, beta, s0, states32, dy, dsf)
        ref = wkv_backward_reference(*rkv, w, beta, s0, dy, dsf)
        for name, a, a32, b in zip(("dr", "dk", "dv", "dw", "dbeta",
                                    "dstate"), out, out32, ref):
            want_dt = bf if name in ("dr", "dk", "dv") else torch.float32
            require(a.dtype == want_dt == b.dtype,
                    f"wkv_backward bf16 {name} {shape}: {a.dtype}, plain "
                    f"{b.dtype}")
            _same_bits(a, a32, f"wkv_backward bf16 {name} {shape}")
            spacing = BF16_SPACING if a.dtype == bf else 0.0
            err_b = max(err_b, max_err(a.float(), b.float(), atol,
                                       rtol + spacing,
                                       f"wkv_backward bf16 {name} {shape}"))

    out = {}
    attrs = _bf16_attrs("rt_wkv_attributes", 64, what="wkv (dh <= 64)",
                        plan_bytes=kernel_plan(64, bf)["shared_bytes"])
    battrs = _bf16_attrs("rt_wkv_backward_attributes", 64,
                         what="wkv_backward (dh <= 64)",
                         plan_bytes=backward_plan(64, bf)["shared_bytes"])
    for d in (32, 128):
        _bf16_attrs("rt_wkv_attributes", d, what=f"wkv (dh <= {d})",
                    plan_bytes=kernel_plan(d, bf)["shared_bytes"])
        _bf16_attrs("rt_wkv_backward_attributes", d,
                    what=f"wkv_backward (dh <= {d})",
                    plan_bytes=backward_plan(d, bf)["shared_bytes"])

    B, S, H, dh = 256, 128, 6, 64            # phase 2's serving shape
    rkv, w, beta, _, _, _ = inputs(B, S, H, dh)
    rkv32 = tuple(t.float() for t in rkv)
    ms = device_ms(lambda: wkv(*rkv, w, beta))
    ms32 = device_ms(lambda: wkv(*rkv32, w, beta))
    plain_ms = cuda_ms(lambda: wkv_reference(*rkv, w, beta), reps=3,
                       warmup=1)
    n = B * S * H * dh
    nbytes = 2 * 3 * n + 4 * (n + B * S * H) + 4 * (n + B * H * dh * dh)
    b = bound(nbytes, 7 * B * H * S * dh * dh)
    out["wkv"] = dict(max_abs_err=err_f, ms=ms, fp32_ms=ms32,
                      plain_ms=plain_ms, library_ms=None, bound_ms=b[0],
                      bound_by=b[1], shape=f"B={B} S={S} H={H} dh={dh}",
                      registers=attrs["registers"],
                      local_bytes=attrs["local_bytes"])
    B, S = 64, 128                           # phase 2's training shape
    rkv, w, beta, _, dy, dsf = inputs(B, S, H, dh)
    rkv32 = tuple(t.float() for t in rkv)
    _, _, states = _forward(*rkv, w, beta, None, save=True)
    ms = device_ms(lambda: wkv_backward(*rkv, w, beta, None, states, dy, dsf))
    ms32 = device_ms(lambda: wkv_backward(*rkv32, w, beta, None, states, dy,
                                          dsf))
    plain_ms = cuda_ms(lambda: wkv_backward_reference(*rkv, w, beta, None,
                                                      dy, dsf), reps=3,
                       warmup=1)
    n = B * S * H * dh
    # reads r k v (bf16), w dy, beta, the states and dsf; writes dr dk dv
    # (bf16), dw, dbeta and dS_0
    nbytes = (2 * 3 * n + 4 * (2 * n + B * S * H + n * dh + B * H * dh * dh)
              + 2 * 3 * n + 4 * (n + B * S * H + B * H * dh * dh))
    b = bound(nbytes, 22 * n * dh)
    out["wkv_backward"] = dict(max_abs_err=err_b, ms=ms, fp32_ms=ms32,
                               plain_ms=plain_ms, library_ms=None,
                               bound_ms=b[0], bound_by=b[1],
                               shape=f"B={B} S={S} H={H} dh={dh}",
                               registers=battrs["registers"],
                               local_bytes=battrs["local_bytes"])
    for name, r in out.items():
        log(f"  {name} bf16 [{r['shape']}]: max_abs_err "
            f"{r['max_abs_err']:.3g} (plain version), ms {r['ms']:.4f} "
            f"(fp32 instance {r['fp32_ms']:.4f}), plain_ms "
            f"{r['plain_ms']:.4f}, bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']})")
    return out


def check_bf16_set_attention(dev, gen) -> dict:
    """(11a) the set-attention bf16 instances (bf16 q, k, v, dO; fp32
    bias; P kept fp32): bitwise the fp32 instances on the upcast inputs
    at the SAB and PMA shapes of serving and training, ragged N and M, N
    and M past one tile (the backward's fp32 scratch), dh 37 (element
    route); against the plain versions at the JAX suite's bf16 bounds;
    timed beside the fp32 instances."""
    from repro_torch.kernels.set_attention import (
        masked_set_attention, set_attention_backward,
        set_attention_backward_reference, set_attention_reference,
    )
    from repro_torch.kernels.set_attention.ops import backward_plan
    bf = torch.bfloat16

    def inputs(B, H, N, M, dh, empty_rows=1):
        q, do = (torch.randn((B, H, N, dh), generator=gen, device=dev).to(bf)
                 for _ in range(2))
        k, v = (torch.randn((B, H, M, dh), generator=gen, device=dev).to(bf)
                for _ in range(2))
        bias = torch.rand((B, M), generator=gen, device=dev)
        mask = torch.rand((B, M), generator=gen, device=dev) < 0.45
        mask[:, 0] = True
        mask[B - empty_rows:] = False            # fully masked rows
        return (q, k, v), bias, mask, do

    fa, fr = BF16_KERNEL_BOUNDS["set_attention"]
    ba, br = BF16_KERNEL_BOUNDS["set_attention_backward"]
    err_f = err_b = 0.0
    for shape in [(512, 4, 64, 64, 64), (512, 4, 1, 64, 64),
                  (64, 4, 64, 64, 64), (64, 4, 1, 64, 64), (3, 2, 7, 13, 44),
                  (2, 3, 5, 33, 37), (2, 2, 7, 130, 16), (2, 2, 130, 70, 36),
                  (2, 2, 1, 300, 44), (2, 2, 70, 13, 128)]:
        qkv, bias, mask, do = inputs(*shape)
        qkv32 = tuple(t.float() for t in qkv)
        o = masked_set_attention(*qkv, bias, mask)
        require(o.dtype == bf, f"set_attention bf16 {shape}: {o.dtype}")
        _same_bits(o, masked_set_attention(*qkv32, bias, mask),
                   f"set_attention bf16 {shape}")
        err_f = max(err_f, max_err(o.float(), set_attention_reference(
            *qkv, bias, mask).float(), fa, fr + BF16_SPACING,
            f"set_attention bf16 {shape}"))
        got = set_attention_backward(*qkv, bias, mask, do)
        got32 = set_attention_backward(*qkv32, bias, mask, do.float())
        ref = set_attention_backward_reference(*qkv, bias, mask, do)
        for name, a, a32, b in zip(("dq", "dk", "dv", "db"), got, got32, ref):
            want_dt = torch.float32 if name == "db" else bf
            require(a.dtype == want_dt == b.dtype,
                    f"set_attention_backward bf16 {name} {shape}: "
                    f"{a.dtype}, plain {b.dtype}")
            _same_bits(a, a32, f"set_attention_backward bf16 {name} {shape}")
            err_b = max(err_b, max_err(
                a.float(), b.float(), ba,
                br + (BF16_SPACING if a.dtype == bf else 0.0),
                f"set_attention_backward bf16 {name} {shape}"))

    attrs = {}
    for what, shape in (("SAB", (64, 64, 64)), ("PMA", (1, 64, 64))):
        attrs[what] = (
            _bf16_attrs("rt_set_attention_forward_attributes", *shape,
                        what=f"set_attention {what}"),
            _bf16_attrs("rt_set_attention_backward_attributes", *shape,
                        what=f"set_attention_backward {what}",
                        plan_bytes=backward_plan(*shape, bf)["shared_bytes"]))

    def timed(fn, plain, qkv, *rest):
        qkv32 = tuple(t.float() for t in qkv)
        rest32 = tuple(t.float() if t.dtype == bf else t for t in rest)
        return (device_ms(lambda: fn(*qkv, *rest)),
                device_ms(lambda: fn(*qkv32, *rest32)),
                cuda_ms(lambda: plain(*qkv, *rest), reps=20))

    def sdpa_ms(qkv, bias, mask, do):
        """One PyTorch call computing the same function in bf16 (the
        yardstick: forward, or its q/k/v backward), as phase 2 times it."""
        import torch.nn.functional as F
        from repro_torch.kernels.set_attention import NEG_INF
        attn_mask = (bias + torch.where(mask, 0.0, NEG_INF)).to(bf)[
            :, None, None, :]
        if do is None:
            return cuda_ms(lambda: F.scaled_dot_product_attention(
                *qkv, attn_mask=attn_mask), reps=50)
        leaves = [t.clone().requires_grad_(True) for t in qkv]
        o = F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask)
        return cuda_ms(lambda: torch.autograd.grad(o, leaves, do,
                                                   retain_graph=True), reps=50)

    out = {}
    for name, fn, plain, B in (
            ("set_attention", masked_set_attention, set_attention_reference,
             512),
            ("set_attention_backward", set_attention_backward,
             set_attention_backward_reference, 64)):
        rec = {}
        for what, N in (("SAB", 64), ("PMA", 1)):
            H, M, dh = 4, 64, 64
            qkv, bias, mask, do = inputs(B, H, N, M, dh, 2)
            rest = (bias, mask) + ((do,) if name != "set_attention" else ())
            ms, ms32, plain_ms = timed(fn, plain, qkv, *rest)
            library_ms = sdpa_ms(qkv, bias, mask,
                                 do if name != "set_attention" else None)
            # products of two bf16 operands (Q K^T; the backward's Q K^T
            # and dO V^T) count at the bf16 peak, those with the fp32 P
            # or dS (P V; dV, dQ, dK) and the softmax at the fp32 peak
            if name == "set_attention":     # q k v in, o out (bf16)
                nbytes = 2 * (2 * B * H * N * dh + 2 * B * H * M * dh)
                flops = B * H * (2 * N * M * dh + 5 * N * M)
                flops16 = B * H * 2 * N * M * dh
            else:                           # q dO k v in, dq dk dv out
                nbytes = (2 * (2 * B * H * N * dh + 2 * B * H * M * dh)
                          + 2 * (B * H * N * dh + 2 * B * H * M * dh)
                          + 4 * B * H * M)
                flops = B * H * (6 * N * M * dh + 12 * N * M)
                flops16 = B * H * 4 * N * M * dh
            b = bound(nbytes + 5 * B * M, flops,   # + the bias and mask
                      flops_bf16=flops16)
            a = attrs[what][0 if name == "set_attention" else 1]
            rec[what] = dict(ms=ms, fp32_ms=ms32, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=b[0],
                             bound_by=b[1], registers=a["registers"],
                             local_bytes=a["local_bytes"],
                             shape=f"B={B} H={H} N={N} M={M} dh={dh}")
        out[name] = dict(max_abs_err=err_f if name == "set_attention"
                         else err_b, **rec["SAB"],
                         pma={k: v for k, v in rec["PMA"].items()})
        for what, r in rec.items():
            log(f"  {name} bf16 {what} [{r['shape']}]: ms {r['ms']:.4f} "
                f"(fp32 instance {r['fp32_ms']:.4f}), plain_ms "
                f"{r['plain_ms']:.4f}, library_ms {r['library_ms']:.4f} "
                f"(SDPA, bf16), bound_ms {r['bound_ms']:.4f} "
                f"({r['bound_by']})")
        log(f"  {name} bf16: max_abs_err {out[name]['max_abs_err']:.3g} "
            "(plain version)")
    return out


def _as_fp32(model, cfg):
    """A model of `cfg` (fp32) holding the values of `model`'s bf16
    weights: the port's fp32 path on the same weights."""
    twin = type(model)(cfg).to(next(model.parameters()).device)
    twin.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    return twin


def _stage_vjp(model, fn, prefixes, x, g, dev, fp32=False):
    """One stage on `dev`: its output for input `x` and, with the
    cotangent `g`, the gradients of its leaves (names starting with
    `prefixes`) and of `x`, all on the CPU. The fp32 evaluation reads x
    and g in fp32."""
    leaves = {n: p for n, p in model.named_parameters()
              if n.startswith(prefixes)}
    if x is not None:
        x = (x.float() if fp32 else x).to(dev).detach()
    if g is None:
        with torch.no_grad():
            return fn(model, x).cpu(), {}, None
    if x is not None:
        x.requires_grad_(True)
    out = fn(model, x)
    inputs = list(leaves.values()) + ([x] if x is not None else [])
    gs = torch.autograd.grad(out, inputs, g.to(dev).to(out.dtype),
                             allow_unused=True, materialize_grads=True)
    grads = {n: t.detach().cpu() for n, t in zip(leaves, gs)}
    gx = gs[-1].detach().cpu() if x is not None else None
    return out.detach().cpu(), grads, gx


def _layerwise(what, stages, cpu, card, fp32, dev, backward):
    """`stages`: [(name, fn(model, x), leaf prefixes)], each stage's input
    the previous one's output. The CPU runs the chain (and, when
    `backward`, the cotangents back from the last stage's scalar); the
    card and its fp32 evaluation run each stage alone on the CPU's input
    and cotangent, the fp32 evaluation's results rounded to the bf16
    path's dtypes. Returns {"card"|"fp32": (the largest output relative
    L2 and its stage, the largest leaf relative L2 and its leaf, the
    median leaf)}; the card's must lie within the bounds, the fp32
    evaluation's outside one of them."""
    xs = [None]
    with torch.no_grad():
        for _, fn, _ in stages:
            xs.append(fn(cpu, xs[-1]))
    cots = [None] * len(stages)
    refs = [(x, {}, None) for x in xs[1:]]
    if backward:
        g = torch.ones(())
        for i in reversed(range(len(stages))):
            cots[i] = g
            refs[i] = _stage_vjp(cpu, stages[i][1], stages[i][2], xs[i], g,
                                 "cpu")
            g = refs[i][2]
    res = {}
    for tag, model in (("card", card), ("fp32", fp32)):
        out_e, leaf_e = [], {}
        for i, (name, fn, prefixes) in enumerate(stages):
            ref, ref_g, ref_gx = refs[i]
            got, grads, gx = _stage_vjp(model, fn, prefixes, xs[i], cots[i],
                                        dev, fp32=tag == "fp32")
            require(tag == "fp32" or got.dtype == ref.dtype,
                    f"{what} {name}: output {got.dtype}, the CPU's "
                    f"{ref.dtype}")
            got = got.to(ref.dtype)
            out_e.append((_rel_l2(got, ref), name,
                          (got != ref).float().mean().item()))
            pairs = [(n, gr, ref_g[n]) for n, gr in grads.items()]
            if gx is not None:
                pairs.append((f"{name} input", gx, ref_gx))
            for n, gr, want in pairs:
                require(tag == "fp32" or gr.dtype == want.dtype,
                        f"{what} {n}: gradient {gr.dtype}, the CPU's "
                        f"{want.dtype}")
                if want.abs().max() > 0:
                    leaf_e[n] = _rel_l2(gr.to(want.dtype), want)
        worst = (max(leaf_e.items(), key=lambda kv: kv[1]) if leaf_e
                 else ("-", 0.0))
        res[tag] = (max(out_e), worst, float(np.median(
            list(leaf_e.values()))) if leaf_e else 0.0)
    (o, (ln, le), med), (o32, (ln32, le32), med32) = res["card"], res["fp32"]
    log(f"  {what}, {len(stages)} stages CPU vs card: outputs largest "
        f"relative L2 {o[0]:.3g} ({o[1]}, {100 * o[2]:.2f}% of its "
        f"elements not the CPU's; fp32 evaluation {o32[0]:.3g}, {o32[1]}, "
        f"{100 * o32[2]:.1f}%)" + (f"; gradients largest {le:.3g} ({ln}; fp32 "
                        f"{le32:.3g}, {ln32}), median leaf {med:.3g} "
                        f"(fp32 {med32:.3g})" if backward else ""))
    require(o[0] <= BF16_MODULE_REL, f"{what} {o[1]}: output relative L2 "
            f"{o[0]:.3g} > {BF16_MODULE_REL}")
    if backward:
        require(le <= BF16_GRAD_REL and med <= BF16_MEDIAN_REL,
                f"{what}: gradient of {ln} relative L2 {le:.3g}, median "
                f"leaf {med:.3g} (bounds {BF16_GRAD_REL}, {BF16_MEDIAN_REL})")
    require(o32[0] > BF16_MODULE_REL or (backward and (
        le32 > BF16_GRAD_REL or med32 > BF16_MEDIAN_REL)),
        f"{what}: the fp32 evaluation passes the bf16 bounds")
    return res


def cross_check_bf16(programs, intervals, cpis, card_dev="cuda"):
    """(11b) the default configs at dtype "bfloat16" from one seed on the
    CPU (plain versions) and on the card (the bf16 instances), stage by
    stage (`_layerwise`): BBEs of BF16_BLOCKS blocks; the pre-training
    loss of a batch of 4 and its gradients; signatures of 8 triplets of
    bf16 BBEs, the Stage-2 loss and its gradients; each against bounds
    that the card's fp32 evaluation fails. Signatures of fp32 BBEs (fp32
    activations on bf16 weights) end to end within 1e-5."""
    from types import SimpleNamespace
    from repro_torch.core.bbe import BBEConfig, BBEEncoder, pretrain_loss
    from repro_torch.core.losses import combined_stage2_loss, l2_normalize
    from repro_torch.core.pipeline import BBEIndex, batch_set_ids
    from repro_torch.core.signature import SignatureConfig, SignatureModel
    from repro_torch.core.tokenizer import default_tokenizer
    from repro_torch.data.corpus import SyntheticBinaryCorp
    from repro_torch.train import triplet_row_batch
    bbe_cfg, sig_cfg = BBEConfig(dtype="bfloat16"), SignatureConfig(
        dtype="bfloat16")
    blocks = [b for p in programs for b in p.unique_blocks][:BF16_BLOCKS]
    toks = torch.from_numpy(default_tokenizer().encode_blocks(
        blocks, bbe_cfg.max_len)).long()
    corp = SyntheticBinaryCorp(n_functions=500, max_len=bbe_cfg.max_len)
    pre = torch.from_numpy(corp.pretrain_batch(0, 4)["tokens"]).long()
    enc = BBEEncoder(bbe_cfg, seed=SEED)
    enc_card = BBEEncoder(bbe_cfg, seed=SEED).to(card_dev)
    models = (enc, enc_card, _as_fp32(enc_card, BBEConfig()), card_dev)
    body = [(f"block {i}", lambda m, x, i=i: m.blocks[i](x),
             (f"blocks.{i}.",)) for i in range(bbe_cfg.num_layers)]

    def embed(tokens):
        return ("embedding", lambda m, _: m.embed(
            tokens.to(m.out_proj.device)), ("embeds.",))

    def pool(m, x):                  # as BBEEncoder.forward
        pooled = m.pool(m.final_norm(x), toks[..., 0].to(x.device) != 0)
        return l2_normalize(pooled @ m.out_proj.to(pooled.dtype))

    def heads(m, x):                 # pretrain_loss after the backbone
        tail = SimpleNamespace(backbone=lambda _: m.final_norm(x),
                               ntp_head=m.ntp_head, nip_head=m.nip_head,
                               cfg=m.cfg)
        return pretrain_loss(tail, {"tokens": pre.to(x.device)})[0]

    out = dict(bbe=_layerwise(
        "bf16 BBEs", [embed(toks)] + body
        + [("pool", pool, ("final_norm.", "pool.", "out_proj"))],
        *models, backward=False))
    out["stage1"] = _layerwise(
        "bf16 pre-training loss", [embed(pre)] + body
        + [("heads", heads, ("final_norm.", "ntp_head.", "nip_head."))],
        *models, backward=True)
    with torch.no_grad():
        e1 = _rel_l2(enc_card(toks.to(card_dev)).float(), enc(toks).float())
    del enc, enc_card, models

    rng = np.random.RandomState(SEED)
    table = {b.bid: rng.randn(sig_cfg.bbe_dim).astype(np.float32)
             for p in programs for b in p.unique_blocks}
    index = BBEIndex(table)
    ext = torch.from_numpy(index.ext)
    ivs = intervals[programs[0].name][:24]
    rows, freqs, mask = (torch.from_numpy(a) for a in
                         batch_set_ids(ivs, index, sig_cfg.max_set))
    model = SignatureModel(sig_cfg, seed=SEED)
    model_card = SignatureModel(sig_cfg, seed=SEED).to(card_dev)
    with torch.no_grad():
        s32 = [m(ext.to(d)[rows.long().to(d)], freqs.to(d), mask.to(d))[0]
               .float().cpu() for m, d in ((model, "cpu"),
                                           (model_card, card_dev))]
    e32 = (s32[1] - s32[0]).abs().max().item()
    require(e32 <= 1e-5, f"signatures of fp32 BBEs on bf16 weights, CPU vs "
            f"card: {e32:.3g} > 1e-5")
    names = [p.name for p in programs[:-1]]
    sets, anchor_cpis = stage2_triplets(names, intervals, cpis,
                                        _phases(names, intervals), 0, 8)
    rb = triplet_row_batch(sets, anchor_cpis, index, sig_cfg.max_set,
                           device="cpu")
    roles = ("anchor", "positive", "negative")
    # the three roles' sets as one batch (each set is computed alone)
    bbes = ext.to(torch.bfloat16)[torch.cat([rb[r]["rows"]
                                             for r in roles]).long()]
    fq = torch.cat([rb[r]["freqs"] for r in roles])
    mk = torch.cat([rb[r]["mask"] for r in roles])
    logw = torch.log1p(fq.float())      # as SetTransformer.forward
    kb = logw / torch.clamp(logw.amax(dim=-1, keepdim=True), min=1e-6)
    B = len(rb["cpi"])

    def on(x, t):
        return t.to(x.device)

    def in_proj(m, _):
        """The BBEs in the model's dtype (the fp32 evaluation reads the
        bf16 values in fp32) with the log-frequency channel."""
        w = m.set_transformer.in_proj.w
        x = bbes.to(w.device).to(w.dtype)
        return m.set_transformer.in_proj(torch.cat(
            [x, on(x, kb)[..., None].to(x.dtype)], dim=-1))

    def sab(i):
        return lambda m, h: m.set_transformer.sabs[i](h, h, on(h, kb),
                                                      on(h, mk))

    def pma(m, h):                   # as SetTransformer and SignatureModel
        st = m.set_transformer
        seeds = st.seeds[None].expand(h.shape[0], -1, -1).to(h.dtype)
        pooled = st.pma(seeds, h, on(h, kb), on(h, mk))
        return l2_normalize(st.out_proj(pooled.reshape(h.shape[0], -1)))

    def losses(m, s):                # as stage2_loss
        return combined_stage2_loss(
            s[:B], s[B:2 * B], s[2 * B:], m.cpi_head(s[:B]),
            on(s, rb["cpi"]), w_r=sig_cfg.w_r, w_c=sig_cfg.w_c)[0]

    out["stage2"] = _layerwise(
        "bf16 Stage 2 on bf16 BBEs",
        [("in_proj", in_proj, ("set_transformer.in_proj.",))]
        + [(f"sab {i}", sab(i), (f"set_transformer.sabs.{i}.",))
           for i in range(sig_cfg.num_sabs)]
        + [("pma", pma, ("set_transformer.pma.", "set_transformer.seeds",
                         "set_transformer.out_proj.")),
           ("losses", losses, ("cpi_head.",))],
        model, model_card, _as_fp32(model_card, SignatureConfig()),
        card_dev, backward=True)
    with torch.no_grad():
        e2 = _rel_l2(model_card(bbes.to(card_dev), fq.to(card_dev),
                                mk.to(card_dev))[0].float(),
                     model(bbes, fq, mk)[0].float())
    log(f"  bf16 full width end to end (not bounded): BBEs relative L2 "
        f"{e1:.3g} CPU vs card ({len(blocks)} blocks), signatures of bf16 "
        f"BBEs {e2:.3g}; signatures of fp32 BBEs max abs {e32:.3g}")
    return dict(out, sig_fp32_bbes=e32, end_to_end=dict(bbe=e1, sig=e2))


def serve_bf16(programs, blocks, intervals, cpis):
    """(11c) the serving path of phase 4 with both models at dtype
    "bfloat16" (the BBE index stays fp32, so Stage 2 runs fp32
    activations on bf16 weights, as JAX's pipeline does)."""
    stages = {}
    svc = main_path(programs, blocks, intervals, cpis, dtype="bfloat16",
                    stages=stages)
    fp32 = FP32_FIGURES.get("serve", {})
    for stage, sec in stages.items():
        log(f"  bf16 stage {stage}: {sec:.3f} s (phase 4, fp32: "
            + (f"{fp32[stage]:.3f} s)" if stage in fp32 else "not run)"))
    return svc, stages


def train_stage1_bf16(dev="cuda") -> dict:
    """(11d) Stage-1 pre-training at the paper's width with dtype
    "bfloat16": BF16_STAGE1_STEPS steps of STAGE1_BATCH x 128 tokens, a
    checkpoint every 3; 12 wkv forward and 12 backward launches a step,
    all of them the bf16 instances."""
    from repro_torch.config import TrainConfig
    from repro_torch.core.bbe import BBEConfig, BBEEncoder, pretrain_loss
    from repro_torch.kernels.wkv import wkv, wkv_backward
    from repro_torch.train import Trainer
    cfg = BBEConfig(dtype="bfloat16")
    pre, _ = _stage1_loaders(cfg, dev)
    ckdir = os.path.join(HERE, "build", "chip_smoke_stage1_bf16")
    shutil.rmtree(ckdir, ignore_errors=True)
    tc = TrainConfig(learning_rate=2e-3, total_steps=BF16_STAGE1_STEPS,
                     warmup_steps=2, checkpoint_every=3,
                     checkpoint_dir=os.path.join(ckdir, "run"))
    encoder = BBEEncoder(cfg, seed=SEED).to(dev)
    n_params = sum(p.numel() for p in encoder.parameters())
    require(n_params == STAGE1_PARAMS, f"{n_params} Stage-1 parameters")
    dtypes = {str(p.dtype) for p in encoder.parameters()}
    require(dtypes == {"torch.bfloat16", "torch.float32"},
            f"bf16 encoder leaf dtypes {dtypes}")
    _peak_reset()
    trainer = Trainer(pretrain_loss, encoder, tc)
    b0 = wkv.launches_bf16, wkv_backward.launches_bf16
    step_s, batch_s, losses = _stage1_run(trainer, pre, BF16_STAGE1_STEPS,
                                          cfg.num_layers, "bf16 pretrain")
    n16 = (wkv.launches_bf16 - b0[0], wkv_backward.launches_bf16 - b0[1])
    want = cfg.num_layers * BF16_STAGE1_STEPS
    require(n16 == (want, want), f"bf16 pre-training launched the bf16 "
            f"instances {n16} times, not {want} each")
    peak = torch.cuda.max_memory_allocated()
    _stage1_report("bf16 pre-training", step_s, batch_s, losses,
                   STAGE1_BATCH, cfg.max_len, peak)
    final = {n: p.detach().clone() for n, p in trainer.state.params.items()}
    del trainer, encoder
    return dict(cfg=cfg, tc=tc, final=final, loader=pre, dev=dev,
                step_ms=1e3 * float(np.median(step_s)),
                tokens_per_s=STAGE1_BATCH * cfg.max_len
                / float(np.median(step_s)), peak_gib=peak / 2 ** 30)


def stage1_bf16_witness(run: dict) -> None:
    """Prints the bf16 step beside phase 5b's fp32 figures (when 5b ran in
    this process), then restores a fresh bf16 Trainer from the step-3
    checkpoint and runs it to the end: bitwise the uninterrupted run's
    weights."""
    from repro_torch.core.bbe import BBEEncoder, pretrain_loss
    from repro_torch.train import Trainer
    fp32 = FP32_FIGURES.get("stage1")
    log(f"  bf16 pre-training step median {run['step_ms']:.2f} ms, "
        f"{run['tokens_per_s']:.0f} tokens/s, peak "
        f"{run['peak_gib']:.3f} GiB; fp32 (phase 5b): " + (
            f"{fp32['step_ms']:.2f} ms, {fp32['tokens_per_s']:.0f} "
            f"tokens/s, peak {fp32['peak_gib']:.3f} GiB" if fp32
            else "not run"))
    tc = run["tc"]
    resumed = os.path.join(os.path.dirname(tc.checkpoint_dir), "resumed")
    os.makedirs(resumed)
    shutil.copytree(os.path.join(tc.checkpoint_dir, "step_0000000003"),
                    os.path.join(resumed, "step_0000000003"))
    trainer = Trainer(pretrain_loss,
                      BBEEncoder(run["cfg"], seed=SEED).to(run["dev"]),
                      dataclasses.replace(tc, checkpoint_dir=resumed))
    trainer.fit(run["loader"], BF16_STAGE1_STEPS,
                log_every=BF16_STAGE1_STEPS)
    differ = [n for n, p in run["final"].items()
              if not torch.equal(p, trainer.state.params[n])]
    require(not differ, f"bf16 stage-1 resume from step 3 is not bitwise "
            f"equal: {differ[:5]}")
    log(f"  bf16 stage-1 resume from the step-3 checkpoint: bitwise equal "
        f"({len(run['final'])} parameters, bf16 leaves but w_bias)")


def train_stage2_bf16(svc, programs, intervals, cpis) -> None:
    """(11e) Stage-2 training on a bf16 BBE matrix (the bf16 service's
    BBEs, rounded to bf16): BF16_STAGE2_STEPS steps of TRAIN_BATCH
    triplets, 9 set-attention forward and 9 backward launches a step, all
    of them the bf16 instances."""
    from repro_torch.config import TrainConfig
    from repro_torch.core.signature import SignatureModel
    from repro_torch.kernels.set_attention import (
        masked_set_attention, set_attention_backward,
    )
    from repro_torch.train import Stage2Engine, triplet_row_batch
    names = [p.name for p in programs[:-1]]
    pipe = svc.pipe
    cfg = pipe.sig_cfg
    index, matrix = pipe._table_index(svc.bbe_table)
    phases = _phases(names, intervals)
    tc = TrainConfig(learning_rate=1e-3, total_steps=BF16_STAGE2_STEPS,
                     warmup_steps=1, checkpoint_every=0,
                     checkpoint_dir=os.path.join(HERE, "build", "unused"))
    eng = Stage2Engine(cfg, SignatureModel(cfg, seed=SEED).to(matrix.device),
                       matrix.to(torch.bfloat16), tc)
    require(eng.matrix.dtype == torch.bfloat16, "the engine's BBE matrix "
            f"is {eng.matrix.dtype}")
    for step in range(BF16_STAGE2_STEPS):
        sets, anchor_cpis = stage2_triplets(names, intervals, cpis, phases,
                                            step, TRAIN_BATCH)
        batch = triplet_row_batch(sets, anchor_cpis, index, cfg.max_set,
                                  device=matrix.device)
        n0 = (masked_set_attention.launches_bf16,
              set_attention_backward.launches_bf16,
              masked_set_attention.launches, set_attention_backward.launches)
        t = time.perf_counter()
        m = eng.step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n = (masked_set_attention.launches_bf16 - n0[0],
             set_attention_backward.launches_bf16 - n0[1],
             masked_set_attention.launches - n0[2],
             set_attention_backward.launches - n0[3])
        require(n == (9, 9, 9, 9), f"bf16 stage-2 step {step}: set-attention "
                f"launches (bf16 fwd, bf16 bwd, fwd, bwd) {n}, not 9 each")
        require(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
                f"bf16 stage-2 step {step}: loss {m['loss']}")
        log(f"  bf16 stage-2 step {step}: loss {m['loss']:.5f} grad_norm "
            f"{m['grad_norm']:.4f} wall {1e3 * wall:.2f} ms")


def bf16_phase(dev, gen, programs, blocks, intervals, cpis) -> dict:
    """Phase 11: (a) the bf16 kernel instances, (b) CPU against the card at
    full width, (c) the serving path, (d) Stage-1 training and (e) Stage 2
    on bf16 BBEs, each path's launches of the four kernels (and of their
    bf16 instances) counted exactly. Returns {kernel: its bf16 record}."""
    from repro_torch.kernels.set_attention import (
        masked_set_attention, set_attention_backward,
    )
    from repro_torch.kernels.wkv import wkv, wkv_backward
    wrappers = {"wkv": wkv, "wkv_backward": wkv_backward,
                "set_attention": masked_set_attention,
                "set_attention_backward": set_attention_backward}
    t0 = time.perf_counter()
    rec = check_bf16_wkv(dev, gen)
    rec.update(check_bf16_set_attention(dev, gen))
    t_a = time.perf_counter() - t0
    cross = cross_check_bf16(programs, intervals, cpis, dev)
    t_b = time.perf_counter() - t0 - t_a
    by_path = {name: {} for name in wrappers}

    def drive(path, fn):
        for w in wrappers.values():
            w.launches = w.launches_bf16 = 0
        out = fn()
        for name, w in wrappers.items():
            if w.launches:
                by_path[name][path] = dict(launches=w.launches,
                                           bf16=w.launches_bf16)
        return out

    from repro_torch.core.bbe import BBEConfig
    layers = BBEConfig().num_layers
    svc, _ = drive("serve_bf16", lambda: serve_bf16(programs, blocks,
                                                    intervals, cpis))
    batches = -(-len(blocks) // svc.cfg.encode_batch)
    want = layers * batches
    got = by_path["wkv"].get("serve_bf16")
    require(got == dict(launches=want, bf16=want),
            f"serve_bf16: wkv launches {got}, not {want}, all bf16")
    require(by_path["set_attention"]["serve_bf16"]["bf16"] == 0,
            "serve_bf16: Stage 2 on the fp32 BBE index took a bf16 instance")
    torch.use_deterministic_algorithms(True)
    try:
        run = drive("stage1_training_bf16", lambda: train_stage1_bf16(dev))
        stage1_bf16_witness(run)
    finally:
        torch.use_deterministic_algorithms(False)
    drive("stage2_bf16", lambda: train_stage2_bf16(svc, programs, intervals,
                                                   cpis))
    log("  bf16 launches by path: " + json.dumps(by_path))
    for name in wrappers:
        rec[name]["launches_by_path"] = by_path[name]
    rec["cross_check"] = cross
    del svc, run
    log(f"bf16 phase: {time.perf_counter() - t0:.3f} s (11a {t_a:.1f} s, "
        f"11b {t_b:.1f} s)")
    return rec


# --------------------------------------------------------------- phase 12

# (N, d, K, valid): JAX's bf16 case, the build's shape (a prefix of the
# build's live rows, then holes), ragged N, d 13 and 20 (rows that are no
# whole 16-byte vectors: the element route), K past one tile
KM_BF16_CASES = [(256, 16, 5, None), (32768, 128, 14, "build"),
                 (32768, 128, 14, "holes"), (4099, 128, 14, "holes"),
                 (1000, 13, 9, "holes"), (777, 20, 30, None),
                 (300, 200, 4, "holes")]
# JAX's bf16 bounds against the plain version (tests/test_kernels.py):
# labels exact; dist2 atol 1.0 / rtol 1e-2; sums and inertia atol 1.0 /
# rtol 5e-2
KM_BF16_D2 = (1.0, 1e-2)
KM_BF16_SUMS = (1.0, 5e-2)
MESH_STAGE2_STEPS = 3
MESH_STAGE1_STEPS = 2


def check_bf16_kmeans(dev, gen, n_valid_build: int) -> dict:
    """(12a) The bf16 instances of both k-means kernels: bitwise the fp32
    instances on the upcast rows (and on widened bf16 centroids), against
    the plain versions at JAX's bf16 bounds, timed beside the fp32
    instances at the build's shape, their resources against the plan.
    Returns {kernel: its bf16 record}."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.kmeans_assign import (
        kmeans_assign, kmeans_assign_reference, kmeans_update,
        kmeans_update_reference,
    )
    from repro_torch.kernels.kmeans_assign.ops import kmeans_plan
    bf = torch.bfloat16
    err_a = err_u = 0.0
    for n, d, k, mask in KM_BF16_CASES:
        x32, c = _clustered(n, d, k, gen, dev)
        x = x32.to(bf)
        up = x.float()
        if mask == "holes":
            valid = (torch.rand((n,), generator=gen, device=dev) < 0.7).float()
        elif mask == "build":
            valid = (torch.arange(n, device=dev) < n_valid_build).float()
        else:
            valid = None
        what = f"(N={n} d={d} K={k})"
        a, d2 = kmeans_assign(x, c)
        a32, d232 = kmeans_assign(up, c)
        require(torch.equal(a, a32) and torch.equal(d2, d232),
                f"kmeans_assign bf16 {what}: not bitwise the fp32 instance")
        a_ref, d2_ref = kmeans_assign_reference(x, c)
        require(torch.equal(a, a_ref), f"kmeans_assign bf16 {what}: labels "
                "differ from the plain version's")
        err_a = max(err_a, max_err(d2, d2_ref, *KM_BF16_D2,
                                   f"kmeans_assign bf16 d2 {what}"))
        got, got32 = kmeans_update(x, c, valid), kmeans_update(up, c, valid)
        require(all(torch.equal(p, q) for p, q in zip(got, got32)),
                f"kmeans_update bf16 {what}: not bitwise the fp32 instance")
        cb = c.to(bf)
        require(all(torch.equal(p, q) for p, q in zip(
            kmeans_update(x, cb, valid), kmeans_update(up, cb.float(),
                                                       valid))),
                f"kmeans_update bf16 {what}: bf16 centroids not widened "
                "exactly")
        ref = kmeans_update_reference(
            x, c, torch.ones((n,), device=dev) if valid is None else valid)
        require(torch.equal(got[1], ref[1]),
                f"kmeans_update bf16 {what}: counts differ")
        err_u = max(err_u, max_err(got[0], ref[0], *KM_BF16_SUMS,
                                   f"kmeans_update bf16 sums {what}"),
                    max_err(got[2], ref[2][0], *KM_BF16_SUMS,
                            f"kmeans_update bf16 inertia {what}"))
    log(f"  k-means bf16 instances: bitwise the fp32 instances at "
        f"{len(KM_BF16_CASES)} shapes; max err vs plain: assign d2 "
        f"{err_a:.3g}, update {err_u:.3g}")
    n, d, k = 32768, 128, 14
    x32, c = _clustered(n, d, k, gen, dev)
    x, up = x32.to(bf), x32.to(bf).float()
    valid = (torch.arange(n, device=dev) < n_valid_build).float()
    nv = n_valid_build
    out = {}
    for name, fn, ref, err, nbytes, flops in (
            ("kmeans_assign", lambda t: kmeans_assign(t, c),
             lambda: kmeans_assign_reference(x, c), err_a,
             2 * n * d + 4 * k * d + 8 * n,
             n * (2 * k * d + 2 * d + 3 * k)),
            ("kmeans_update", lambda t: kmeans_update(t, c, valid),
             lambda: kmeans_update_reference(x, c, valid), err_u,
             2 * nv * d + 4 * n + 4 * k * d + 4 * (k * d + k + 1),
             nv * (2 * k * d + 2 * d + 3 * k + d))):
        entry = f"rt_{name}_attributes"
        a = _lib.kernel_attributes(entry, 1, d, k)
        plan = kmeans_plan(1, d, k, bf)["shared_bytes"]
        log(f"  {name} bf16 instance (d={d} K={k}): {describe(a)}; plan "
            f"{plan} shared bytes")
        require(a["dynamic_smem"] == plan and a["static_smem"] == 0,
                f"{name} bf16: shared bytes differ from kmeans_plan's")
        for dd, kk in ((13, 9), (20, 30), (200, 4)):
            b = _lib.kernel_attributes(entry, 1, dd, kk)
            require(b["dynamic_smem"] == kmeans_plan(1, dd, kk, bf)[
                "shared_bytes"], f"{name} bf16 (d={dd} K={kk}): shared "
                "bytes differ from kmeans_plan's")
        ms, ms32 = device_ms(lambda: fn(x)), device_ms(lambda: fn(up))
        plain_ms = cuda_ms(ref, reps=20)
        b = bound(nbytes, flops)
        out[name] = dict(max_abs_err=err, ms=ms, fp32_ms=ms32,
                         plain_ms=plain_ms, library_ms=None, bound_ms=b[0],
                         bound_by=b[1],
                         shape=f"N={n} (valid {nv}) d={d} K={k}",
                         registers=a["registers"],
                         local_bytes=a["local_bytes"], shared_bytes=plan,
                         launches_by_path={})
        log(f"  {name} bf16 [{out[name]['shape']}]: max_abs_err {err:.3g} "
            f"(plain version), ms {ms:.4f} (fp32 instance {ms32:.4f}), "
            f"plain_ms {plain_ms:.4f}, bound_ms {b[0]:.4f} ({b[1]})")
    return out


def _same_state(a: dict, b: dict, what: str) -> None:
    from repro_torch.train import checkpoint as ckpt
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    require(sorted(fa) == sorted(fb), f"{what}: other leaves")
    differ = [k for k in fa if not torch.equal(fa[k], fb[k])]
    require(not differ, f"{what}: not bitwise equal at {differ[:5]}")


def mesh_runs(svc, programs, intervals, cpis, mesh, ddir, dev):
    """(12b, 12c) The k-means build, Stage-2 and Stage-1 steps, under
    `mesh` (None: the same runs unsharded). Returns what 12b-12e compare,
    and the engine and Stage-2 batch function."""
    from repro_torch.config import TrainConfig
    from repro_torch.core.bbe import BBEConfig, BBEEncoder, pretrain_loss
    from repro_torch.core.clustering import kmeans_device
    from repro_torch.kernels.kmeans_assign import kmeans_assign, kmeans_update
    from repro_torch.train import Stage2Engine, Trainer, triplet_row_batch
    tag = "mesh" if mesh is not None else "plain"
    out = {"wall": {}}

    def timed(what, fn):
        sync(dev)
        t = time.perf_counter()
        r = fn()
        sync(dev)
        out["wall"].setdefault(what, []).append(time.perf_counter() - t)
        return r

    kb, store = svc.kb, svc.store
    u0, a0 = kmeans_update.launches, kmeans_assign.launches
    timed("build", lambda: kb.build(k=14, seed=svc.cfg.kmeans_seed,
                                    mesh=mesh))
    out["build_launches"] = (kmeans_update.launches - u0,
                             kmeans_assign.launches - a0)
    out["archetypes"] = kb.archetypes.copy()
    out["reps"] = kb.rep_global_idx.copy()
    out["fingerprints"] = {p: f.copy() for p, f in kb.fingerprints.items()}
    valid = store.device_valid if store.has_tombstones else None
    out["labels"] = kmeans_device(store.device_matrix, 14,
                                  seed=svc.cfg.kmeans_seed,
                                  n_valid=len(store), valid_mask=valid,
                                  mesh=mesh)

    names = [p.name for p in programs[:-1]]
    pipe = svc.pipe
    cfg = pipe.sig_cfg
    index, matrix = pipe._table_index(svc.bbe_table)
    phases = _phases(names, intervals)

    def batch_fn(step):
        sets, anchor_cpis = stage2_triplets(names, intervals, cpis, phases,
                                            step, TRAIN_BATCH)
        return triplet_row_batch(sets, anchor_cpis, index, cfg.max_set,
                                 device=matrix.device)

    tc = TrainConfig(learning_rate=1e-3, total_steps=TRAIN_STEPS,
                     warmup_steps=2, checkpoint_every=0,
                     checkpoint_dir=os.path.join(ddir, f"stage2_{tag}"))
    eng = Stage2Engine(cfg, pipe.sig_model, matrix, tc, mesh=mesh)
    out["stage2_metrics"] = [timed("stage2_step", lambda: eng.step(
        batch_fn(s))) for s in range(MESH_STAGE2_STEPS)]
    out["stage2_state"] = {"params": {k: v.detach().clone() for k, v in
                                      eng.params.items()},
                           "opt": eng.trainer._full_opt_state()}
    if mesh is not None:
        eng.maybe_checkpoint(force=True)

    bcfg = BBEConfig()
    pre, _ = _stage1_loaders(bcfg, dev)
    tr = Trainer(pretrain_loss, BBEEncoder(bcfg, seed=SEED).to(dev),
                 TrainConfig(learning_rate=2e-3, total_steps=STAGE1_STEPS,
                             warmup_steps=max(2, STAGE1_STEPS // 20),
                             checkpoint_every=0,
                             checkpoint_dir=os.path.join(ddir, "stage1")),
                 mesh=mesh)
    out["stage1_metrics"] = [timed("stage1_step", lambda: tr.step(pre(s)))
                             for s in range(MESH_STAGE1_STEPS)]
    out["stage1_params"] = {k: v.detach().clone()
                            for k, v in tr.state.params.items()}
    del tr
    return out, eng, batch_fn


def mesh_phase(svc, programs, intervals, cpis, drive,
               dev=torch.device("cuda")) -> dict:
    """Phase 12 (b)-(e) on one rank (NCCL on the card, gloo on the CPU): the
    same runs without a mesh and under a (1, 1) ("data", "model") mesh,
    bitwise; only the mesh runs count, on the "mesh" path. Returns the
    phase's record."""
    import torch.distributed as dist
    from repro_torch.core.signature import stage2_loss_from_rows
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import Stage2Engine
    from repro_torch.train.compression import compress_tree
    ddir = os.path.join(HERE, "build", "chip_smoke_mesh")
    shutil.rmtree(ddir, ignore_errors=True)
    os.makedirs(ddir)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        store=dist.FileStore(os.path.join(ddir, "store"), 1), rank=0,
        world_size=1)
    rec = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        require(mesh.device_type == dev.type, f"mesh on {mesh.device_type}")
        # each group's communicator starts at its first collective: start
        # them here, so that the timed runs below do not hold it
        for i in range(mesh.ndim):
            dist.all_reduce(torch.zeros(1, device=dev), group=mesh.get_group(i))
        sync(dev)
        t_init = time.perf_counter() - t0
        torch.use_deterministic_algorithms(True)
        try:
            plain, eng_p, batch_fn = mesh_runs(svc, programs, intervals,
                                               cpis, None, ddir, dev)
            got, eng_m, _ = drive("mesh", lambda: mesh_runs(
                svc, programs, intervals, cpis, mesh, ddir, dev))
        finally:
            torch.use_deterministic_algorithms(False)
        # 12b
        require(got["build_launches"] == plain["build_launches"],
                f"k-means launches a build: {got['build_launches']} under "
                f"the mesh, {plain['build_launches']} without")
        for key in ("archetypes", "reps"):
            require(np.array_equal(got[key], plain[key]),
                    f"KnowledgeBase.build(mesh=): {key} differ")
        require(got["fingerprints"].keys() == plain["fingerprints"].keys()
                and all(np.array_equal(v, plain["fingerprints"][k])
                        for k, v in got["fingerprints"].items()),
                "KnowledgeBase.build(mesh=): fingerprints differ")
        for i, what in enumerate(("centroids", "labels")):
            require(np.array_equal(got["labels"][i], plain["labels"][i]),
                    f"kmeans_device(mesh=): {what} differ")
        require(got["labels"][2] == plain["labels"][2],
                "kmeans_device(mesh=): inertia differs")
        log(f"  12b: the k-means build under the mesh bitwise the unsharded "
            f"one (centroids, labels, representatives, fingerprints); "
            f"kmeans_update/kmeans_assign launches a build "
            f"{got['build_launches']}")
        # 12c
        for key in ("stage2_metrics", "stage1_metrics"):
            require(got[key] == plain[key], f"{key}: {got[key]} under the "
                    f"mesh, {plain[key]} without")
        _same_state(got["stage2_state"], plain["stage2_state"],
                    "Stage-2 steps under the mesh")
        _same_state(got["stage1_params"], plain["stage1_params"],
                    "Stage-1 steps under the mesh")
        log(f"  12c: {MESH_STAGE2_STEPS} Stage-2 and {MESH_STAGE1_STEPS} "
            f"Stage-1 steps under the mesh bitwise the unsharded steps "
            f"(params, optimizer state, metrics)")
        walls = {k: (1e3 * min(got["wall"][k]), 1e3 * min(plain["wall"][k]))
                 for k in got["wall"]}
        log("  wall ms, mesh / unsharded (least of the calls): " + ", ".join(
            f"{k} {m:.2f} / {p:.2f}" for k, (m, p) in walls.items()))
        # 12d
        eng_r = Stage2Engine(eng_p.sig_cfg, svc.pipe.sig_model,
                             eng_p.matrix, eng_m.trainer.cfg)
        require(eng_r.restore() and eng_r.step_count == MESH_STAGE2_STEPS,
                "the mesh checkpoint did not restore")
        _same_state({"params": dict(eng_r.params),
                     "opt": eng_r.trainer.state.opt_state},
                    got["stage2_state"], "the mesh checkpoint restored "
                    "without a mesh")
        log("  12d: the checkpoint written under the mesh restores without "
            "one, bitwise")
        # 12e
        batch = batch_fn(MESH_STAGE2_STEPS)
        loss, _ = stage2_loss_from_rows(eng_r.model, eng_r.sig_cfg,
                                        eng_r.matrix, batch)
        names = list(eng_r.params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [eng_r.params[n] for n in names])))
        err = err_cpu = None
        for _ in range(2):
            q, sc, err = compress_tree(grads, err)
            qc, scc, err_cpu = compress_tree(
                {k: g.cpu() for k, g in grads.items()}, err_cpu)
            for k in names:
                require(torch.equal(q[k].cpu(), qc[k])
                        and torch.equal(sc[k].cpu(), scc[k])
                        and torch.equal(err[k].cpu(), err_cpu[k]),
                        f"compress_tree on the card differs from the "
                        f"CPU's at {k}")
        log(f"  12e: compress_tree on the card bitwise the CPU's ({len(names)}"
            f" gradient leaves, two error-feedback steps)")
        rec = dict(pg_init_s=t_init, build_launches=got["build_launches"],
                   wall_ms=walls, seconds=time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()
    return rec


def time_kernels(root: str) -> dict:
    """Device and wrapper ms of wkv (the encoder's shape), of the
    set-attention backward (Stage-2 training's SAB and PMA shapes) and of
    both k-means kernels (the build's shape: 32,768 store rows, 18,000 of
    them live, d 128, K 14) of the port under root/src, on inputs drawn
    from SEED."""
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.kernels import _lib
    from repro_torch.kernels.kmeans_assign import kmeans_assign, kmeans_update
    from repro_torch.kernels.set_attention import set_attention_backward
    from repro_torch.kernels.wkv import wkv
    _lib.load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B, S, H, dh = 256, 128, 6, 64
    r, k, v = (torch.randn((B, S, H, dh), generator=gen, device=dev)
               for _ in range(3))
    k = k / k.norm(dim=-1, keepdim=True)
    w = 0.7 + 0.3 * torch.rand((B, S, H, dh), generator=gen, device=dev)
    beta = torch.rand((B, S, H), generator=gen, device=dev)
    out = {"wkv": kernel_ms(lambda: wkv(r, k, v, w, beta), reps=20)}
    for name, N in (("backward_sab", 64), ("backward_pma", 1)):
        B, H, M, dh = 64, 4, 64, 64
        q, do = (torch.randn((B, H, N, dh), generator=gen, device=dev)
                 for _ in range(2))
        kk, vv = (torch.randn((B, H, M, dh), generator=gen, device=dev)
                  for _ in range(2))
        bias = torch.rand((B, M), generator=gen, device=dev)
        mask = torch.rand((B, M), generator=gen, device=dev) < 0.45
        mask[:, 0] = True
        out[name] = kernel_ms(lambda: set_attention_backward(
            q, kk, vv, bias, mask, do), reps=100)
    x, c = _clustered(32768, 128, 14, gen, dev)
    valid = (torch.arange(32768, device=dev) < 18 * N_INTERVALS).float()
    out["kmeans_update"] = kernel_ms(lambda: kmeans_update(x, c, valid),
                                     reps=100)
    out["kmeans_assign"] = kernel_ms(lambda: kmeans_assign(x, c), reps=100)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward, flash_forward,
    )
    for name, (B, S, H, K, D) in (("flash_smollm", FLASH_CASES[0][:2]
                                   + FLASH_CASES[0][3:6]),
                                  ("flash_qwen3_moe", MOE_FLASH_SHAPE)):
        q = torch.randn((B, S, H, D), generator=gen, device=dev).bfloat16()
        kk, vv = (torch.randn((B, S, K, D), generator=gen,
                              device=dev).bfloat16() for _ in range(2))
        out[name] = kernel_ms(lambda: flash_attention(q, kk, vv), reps=20)
        del q, kk, vv
    # the bf16 flash backward at the training shapes (the same entry point
    # since it was added)
    for name, (B, S, T, H, K, D), causal, P in FLASH_BWD_SHAPES:
        q, kk, vv = _flash_inputs(gen, dev, B, S, T, H, K, D, torch.bfloat16)
        do = torch.randn((B, S, H, D), generator=gen, device=dev).bfloat16()
        o, lse = flash_forward(q, kk, vv, causal=causal, prefix_len=P,
                               return_lse=True)
        out["flash_backward_" + name.replace(" ", "_")] = kernel_ms(
            lambda: flash_attention_backward(q, kk, vv, o, do, lse,
                                             causal=causal, prefix_len=P),
            reps=5)
        del q, kk, vv, do, o, lse
    # shared loads and FMAs of the kernels' SASS (the backward's and the
    # k-means kernels by their names before and since their redesigns)
    lib = str(_lib.build_library())
    out["sass"] = {name: sass_counts(lib, fn, SASS_OPS) for name, fn in (
        ("wkv", "wkv_forward_kernel"),
        ("backward", "set_attention_backward_kernel"),
        ("backward_sab", "bwd12tiled_kernel"),
        ("backward_pma", "bwd14small_n_kernel"),
        ("kmeans_assign_kernel", "kmeans_assign_kernel"),
        ("kmeans_update_partial_kernel", "kmeans_update_partial_kernel"),
        ("kmeans_update_reduce_kernel", "kmeans_update_reduce_kernel"),
        ("assign_rows_kernel", "assign_rows_kernel"),
        ("update_rows_kernel", "update_rows_kernel"),
        ("update_join_kernel", "update_join_kernel"))}
    # the flash backward's kernels by their names before and since their
    # redesign (the FMA kernels are fp32 only since)
    out["sass"].update({name: sass_counts(lib, fn, SASS_OPS + ("HGMMA*",))
                        for name, fn in (
                            ("flash_dkdv_kernel", "dkdv_kernel"),
                            ("flash_dq_kernel", "dq_kernel"),
                            ("flash_dkdv_wgmma_kernel", "dkdv_wgmma_kernel"),
                            ("flash_dq_wgmma_kernel", "dq_wgmma_kernel"))})
    return out


def profile_stage1() -> int:
    """Where a Stage-1 pre-training step of phases 5b (fp32) and 11d
    (bf16) goes: for each dtype, 3 steps under torch.profiler after 3
    warm-up steps (batches made beforehand). Prints the host wall a step,
    the kernels a step, the device's busy time a step (the union of
    kernel intervals) and its share of the wall, the device time by kind
    (matmul, wkv, other) and the top kernels."""
    from repro_torch.config import TrainConfig
    from repro_torch.core.bbe import BBEConfig, BBEEncoder, pretrain_loss
    from repro_torch.kernels import _lib
    from repro_torch.train import Trainer
    _lib.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(_card_name())
    for dtype in ("float32", "bfloat16"):
        cfg = BBEConfig(dtype=dtype)
        pre, _ = _stage1_loaders(cfg, "cuda")
        batches = [pre(s) for s in range(6)]
        trainer = Trainer(pretrain_loss,
                          BBEEncoder(cfg, seed=SEED).to("cuda"),
                          TrainConfig(learning_rate=2e-3, total_steps=20,
                                      warmup_steps=2, checkpoint_every=0))
        for b in batches[:3]:
            trainer.step(b)
        torch.cuda.synchronize()
        _profile(lambda: [trainer.step(b) for b in batches[3:]],
                 len(batches) - 3, f"stage-1 pre-training step, {dtype} "
                 f"({STAGE1_BATCH} x {cfg.max_len} tokens", "wkv_")
        del trainer
    return 0


def _card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    return smi.splitlines()[0]


def _profile(fn, n: int, what: str, kernel: str) -> None:
    """Runs fn() (n calls of what is profiled) under torch.profiler and
    prints the host wall a call, the kernels a call, the device's busy
    time a call (the union of kernel intervals) and its share of the
    wall, the device time by kind (matmul; the port's kernel whose name
    holds `kernel`; other) and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / n
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:                       # union of kernel intervals, us
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        c, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, us + e.time_range.elapsed_us())
    name = kernel.strip("_")
    kinds = {"matmul": 0.0, name: 0.0, "other": 0.0}
    for kname, (_, us) in by_name.items():
        low = kname.lower()
        kind = (name if kernel in low else "matmul"
                if any(m in low for m in ("gemm", "cutlass", "xmma", "nvjet"))
                else "other")
        kinds[kind] += us
    log(f"{what}, {n} calls profiled): wall {1e3 * wall:.2f} ms, "
        f"{len(kernels) / n:.0f} kernels, device busy {busy / 1e3 / n:.2f} ms "
        f"({100 * busy / 1e3 / n / (1e3 * wall):.1f}% of the wall)")
    log("  device ms a call by kind: " + ", ".join(
        f"{k} {v / 1e3 / n:.2f}" for k, v in kinds.items()))
    for kname, (c, us) in sorted(by_name.items(), key=lambda x: -x[1][1])[:15]:
        log(f"  {us / 1e3 / n:8.3f} ms {c // n:5d} x  {kname[:90]}")


def profile_moe() -> int:
    """Where qwen3-moe's prefill and decode step go at phase 8c's widths
    (bf16, seeded), cut to MOE_PROFILE_LAYERS layers (a layer's work does
    not depend on the depth): 2 prefill calls of MOE_PREFILL tokens, then
    5 decode steps on 8 slots, each after a warm-up, under torch.profiler
    (`_profile`)."""
    from repro_torch.config import get_arch
    from repro_torch.kernels import _lib
    from repro_torch.models.model_zoo import build_model
    _lib.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(MOE_ARCH),
                              num_layers=MOE_PROFILE_LAYERS)
    model = build_model(cfg)
    params = model.init(SEED, device="cuda")
    rng = np.random.RandomState(SEED)
    B, S = MOE_PREFILL
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    model.prefill(params, {"tokens": tokens})
    log(_card_name())
    _profile(lambda: [model.prefill(params, {"tokens": tokens})
                      for _ in range(2)], 2,
             f"{cfg.name} prefill ({cfg.num_layers} layers, {B} x {S} tokens",
             "flash")
    slots = MOE_SERVE[4]
    cache = model.init_cache(slots, MOE_SERVE[5], torch.float32,
                             device="cuda")
    step = torch.from_numpy(rng.randint(0, cfg.vocab_size, (slots, 1))).cuda()
    pos = torch.arange(slots, device="cuda")
    for i in range(2):
        model.decode_step(params, cache, step, pos + i)
    _profile(lambda: [model.decode_step(params, cache, step, pos + 2 + i)
                      for i in range(5)], 5,
             f"{cfg.name} decode step ({cfg.num_layers} layers, {slots} "
             f"slots", "flash")
    return 0


def versus(other: str) -> int:
    """`time_kernels` of the checkout at `other` and of this one, in turns,
    each in its own process."""
    log(_card_name())
    for tag, root in (("other", other), ("this", HERE), ("this", HERE),
                      ("other", other)):
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--time-kernels", os.path.abspath(root)],
                             capture_output=True, text=True, timeout=900)
        if run.returncode:
            print(run.stdout + run.stderr, file=sys.stderr)
            return 1
        times = json.loads(run.stdout.strip().splitlines()[-1])
        sass = times.pop("sass")
        log(f"{tag} ({root}): " + ", ".join(
            f"{name} ms {t[0]:.4f} (wrapper {t[1]:.4f})"
            for name, t in times.items()))
        log(f"  SASS: {sass}")
    return 0


def main() -> int:
    if sys.argv[1:] in (["--profile-stage1"], ["--profile-moe"]):
        if not torch.cuda.is_available():
            print("chip_smoke: CUDA is not available", file=sys.stderr)
            return 2
        sys.path.insert(0, os.path.join(HERE, "src"))
        return (profile_stage1() if sys.argv[1] == "--profile-stage1"
                else profile_moe())
    if len(sys.argv) == 3 and sys.argv[1] in ("--versus", "--time-kernels"):
        if not torch.cuda.is_available():
            print("chip_smoke: CUDA is not available", file=sys.stderr)
            return 2
        if sys.argv[1] == "--versus":
            return versus(sys.argv[2])
        print(json.dumps(time_kernels(sys.argv[2])), flush=True)
        return 0
    moe_only = sys.argv[1:] == ["--moe"]
    modal_only = sys.argv[1:] == ["--modal"]
    train_only = sys.argv[1:] == ["--lm-train"]
    bf16_only = sys.argv[1:] == ["--bf16"]
    mesh_only = sys.argv[1:] == ["--mesh"]
    t_run = time.perf_counter()
    # cuBLAS takes its workspace layout when CUDA starts: the fixed one
    # that deterministic algorithms (phase 5) need
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward,
    )
    from repro_torch.kernels.kmeans_assign import kmeans_assign, kmeans_update
    from repro_torch.kernels.set_attention import (
        masked_set_attention, set_attention_backward,
    )
    from repro_torch.kernels.wkv import wkv, wkv_backward

    # plain versions on the card must be true fp32 (no TF32), and bf16
    # matrix products sum in fp32, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # 1. setup
    card = _card_name()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    _lib.load_library()
    log(f"kernel library built and loaded in {time.perf_counter() - t:.1f} s")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if moe_only or modal_only:
        # phase 8 or 9 alone, each path held to its flash launches
        want = {"zoo_moe": 3 * MOE_LAYERS, **modal_launches()}

        def count(path, fn):
            flash_attention.launches = 0
            fn()
            log(f"{path} launches: flash_attention "
                f"{flash_attention.launches}")
            require(flash_attention.launches == want[path],
                    f"{path}: not {want[path]} flash launches")

        if moe_only:
            moe_phase(dev, gen, count)
        else:
            check_flash_cases(dev, gen)
            modal_phase(dev, gen, count)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if train_only:
        # phase 10 alone, its path held to its flash launches
        def count_train(path, fn):
            flash_attention.launches = flash_attention_backward.launches = 0
            out = fn()
            got = {"flash_attention": flash_attention.launches,
                   "flash_attention_backward":
                       flash_attention_backward.launches}
            log(f"{path} launches: {got}")
            require(got == lm_train_launches(),
                    f"{path}: launches {got}, not {lm_train_launches()}")
            return out

        lm_train_phase(dev, gen, count_train)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    t = time.perf_counter()
    programs, blocks, intervals, cpis = make_world()
    log(f"world: {len(programs)} programs, {len(blocks)} blocks, "
        f"{sum(map(len, intervals.values()))} intervals "
        f"({time.perf_counter() - t:.1f} s on the host)")
    n_valid_build = (len(programs) - 1) * N_INTERVALS
    if bf16_only:
        # phase 11 alone
        rec = bf16_phase(dev, gen, programs, blocks, intervals, cpis)
        log(card)
        log(json.dumps({"bf16": rec}))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if mesh_only:
        # phase 12 alone, after phase 4's serving path
        from repro_torch.kernels.set_attention import (
            masked_set_attention, set_attention_backward,
        )
        wrappers = {"wkv": wkv, "wkv_backward": wkv_backward,
                    "set_attention": masked_set_attention,
                    "set_attention_backward": set_attention_backward,
                    "kmeans_assign": kmeans_assign,
                    "kmeans_update": kmeans_update}
        by_path = {}

        def drive_only(path, fn):
            for w in wrappers.values():
                w.launches = 0
            out = fn()
            for name, w in wrappers.items():
                if w.launches:
                    by_path.setdefault(name, {})[path] = w.launches
            return out

        svc = main_path(programs, blocks, intervals, cpis)
        t12 = time.perf_counter()
        km = check_bf16_kmeans(dev, gen, n_valid_build)
        rec = mesh_phase(svc, programs, intervals, cpis, drive_only)
        log(f"phase 12: {time.perf_counter() - t12:.1f} s; launches on the "
            f"mesh path: {json.dumps(by_path)}")
        log(card)
        log(json.dumps({"mesh": dict(rec, kmeans_bf16=km,
                                     launches_by_path=by_path)}))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # 2. kernels against their plain versions
    wrappers = {"wkv": wkv, "wkv_backward": wkv_backward,
                "set_attention": masked_set_attention,
                "kmeans_assign": kmeans_assign, "kmeans_update": kmeans_update,
                "set_attention_backward": set_attention_backward,
                "flash_attention": flash_attention,
                "flash_attention_backward": flash_attention_backward}
    checks = {
        "wkv": lambda: check_wkv(dev, gen),
        "wkv_backward": lambda: check_wkv_backward(dev, gen),
        "set_attention": lambda: check_set_attention(dev, gen),
        "kmeans_assign": lambda: check_kmeans_assign(dev, gen),
        "kmeans_update": lambda: check_kmeans_update(dev, gen, n_valid_build),
        "set_attention_backward": lambda: check_set_attention_backward(dev,
                                                                       gen),
    }
    results = {}
    for name, fn in checks.items():
        r = fn()
        results[name] = r
        lib_ms = ("null" if r["library_ms"] is None
                  else f"{r['library_ms']:.4f}")
        log(f"kernel {name} [{r['shape']}]: max_abs_err {r['err']:.3g}, "
            f"ms {r['ms']:.4f} (wrapper {r['wrapper_ms']:.4f}), plain_ms "
            f"{r['plain_ms']:.4f}, library_ms "
            f"{lib_ms}, bound_ms {r['bound'][0]:.4f} ({r['bound'][1]})")

    # 3. full-width CPU vs card on a small input
    cross_check_full_width(programs, intervals)
    cross_check_stage2_grads(programs, intervals, cpis)
    cross_check_stage1_grads()

    # 4. the serving path; `launches` is each kernel's count on its own
    # path, `by_path` its count on every path that launched it
    def drive(path, fn):
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        for name, w in wrappers.items():
            if w.launches:
                by_path.setdefault(name, {})[path] = w.launches
        return out

    by_path = {}
    t = time.perf_counter()
    svc = drive("serve", lambda: main_path(
        programs, blocks, intervals, cpis,
        stages=FP32_FIGURES.setdefault("serve", {})))
    log(f"main path: {time.perf_counter() - t:.3f} s")
    for name in ("wkv", "set_attention", "kmeans_assign", "kmeans_update"):
        require(by_path.get(name, {}).get("serve", 0) > 0,
                f"kernel {name} was not launched on the serving path")
    repeated_builds(svc)

    # 4b, 4c: the store's lifecycle, then Fig. 4's SimPoint flow over the
    # semantic signatures as phase 4 left them; each path's launches are
    # read before the gates that hold it to a witness run
    names = [p.name for p in programs]
    semantic = {n: svc.store.signatures[svc.store.rows_for(n)].copy()
                for n in names}
    for phase, path, fn in (
            ("lifecycle", "lifecycle",
             lambda: lifecycle(svc, programs, intervals)),
            ("SimPoint", "simpoint",
             lambda: simpoint_flow(programs, blocks, intervals, cpis,
                                   semantic))):
        t = time.perf_counter()
        out = drive(path, fn)
        log(f"{phase} path: {time.perf_counter() - t:.3f} s; launches "
            + ", ".join(f"{name} {n[path]}" for name, n in by_path.items()
                        if path in n))
        require(all(path in by_path[name]
                    for name in ("kmeans_assign", "kmeans_update")),
                f"the k-means kernels were not launched on the {phase} path")
        if path == "lifecycle":
            lifecycle_witness(svc, out)
        else:
            simpoint_card_vs_cpu(names, out, semantic)
    del semantic, out

    # 5. Stage-2 training, under deterministic algorithms so that a
    # library op that is not deterministic raises
    torch.use_deterministic_algorithms(True)
    try:
        fwd, bwd = drive("train", lambda: train_stage2(svc, programs,
                                                       intervals, cpis))
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"stage-2 training launches: set_attention {fwd}, "
        f"set_attention_backward {bwd}")
    require(fwd > 0 and bwd == 9 * (TRAIN_STEPS + TRAIN_STEPS - 10),
            "a set-attention kernel was not launched as expected in training")

    # 5b. Stage-1 training, under deterministic algorithms; the resume
    # witness runs after the path's launches are read and counts on none
    torch.use_deterministic_algorithms(True)
    try:
        t = time.perf_counter()
        run = drive("stage1_training", train_stage1)
        n = {name: by_path.get(name, {}).get("stage1_training", 0)
             for name in ("wkv", "wkv_backward")}
        log(f"stage-1 training path: {time.perf_counter() - t:.3f} s; "
            f"launches wkv {n['wkv']}, wkv_backward {n['wkv_backward']}")
        want = 12 * STAGE1_STEPS + 36 * TRIPLET_STEPS
        require(n == {"wkv": want, "wkv_backward": want},
                f"stage-1 training launched the wkv kernels {n}, not {want}")
        stage1_witness(run)
    finally:
        torch.use_deterministic_algorithms(False)
    del run

    # 6. the LM zoo: (a) the flash kernel, (b) CPU vs card at full width,
    # (c) the dense serving path; only (c)'s launches count
    t = time.perf_counter()
    results["flash_attention"] = r = check_flash(dev, gen)
    log(f"kernel flash_attention [{r['shape']}]: max_abs_err {r['err']:.3g}, "
        f"ms {r['ms']:.4f} (wrapper {r['wrapper_ms']:.4f}), plain_ms "
        f"{r['plain_ms']:.4f}, library_ms "
        f"{r['library_ms']:.4f}, bound_ms {r['bound'][0]:.4f} "
        f"({r['bound'][1]})")
    cross_check_zoo(dev)
    drive("zoo", lambda: zoo_path(dev))
    require(by_path.get("flash_attention", {}).get("zoo", 0) > 0,
            "flash_attention was not launched on the zoo path")
    log(f"zoo phase: {time.perf_counter() - t:.3f} s")

    # 7. the recurrent zoo: (a) wkv at the zoo's shapes, (b, c) CPU vs card
    # for the encoder, then the serving path of the encoder and xlstm, then
    # (c, d) CPU vs card for xlstm (one period) and a jamba-width Mamba;
    # only the serving path's launches count
    t = time.perf_counter()
    wkv_zoo = check_wkv_zoo(dev, gen)
    cross_check_encoder(dev)
    drive("zoo_recurrent", lambda: recurrent_zoo_path(dev))
    require(by_path.get("wkv", {}).get("zoo_recurrent", 0) > 0,
            "wkv was not launched on the recurrent zoo path")
    cross_check_xlstm(dev)
    cross_check_mamba(dev)
    log(f"recurrent zoo phase: {time.perf_counter() - t:.3f} s")
    results["wkv"]["extra"]["zoo_shapes"] = wkv_zoo

    # 8. the zoo's MoE archs: (a) flash at qwen3-moe's prefill shape, (b)
    # CPU vs card (qwen3-moe cut to 1 layer, grok-1's mixer), (c) qwen3-moe
    # at 8 layers served; only (c)'s launches count
    flash_moe = moe_phase(dev, gen, drive)
    n_moe = by_path.get("flash_attention", {}).get("zoo_moe", 0)
    require(n_moe == 3 * MOE_LAYERS,
            f"flash_attention launched {n_moe} times on the MoE zoo path, "
            f"not {3 * MOE_LAYERS}")
    results["flash_attention"]["extra"]["moe_shape"] = flash_moe

    # 9. the encoder-decoder and the prefix-LM: (a) flash's prefix rule and
    # the modal shapes, (b) CPU vs card, (c) whisper-tiny and (d)
    # paligemma-3b served; only (c)'s and (d)'s launches count
    flash_modal = modal_phase(dev, gen, drive)
    for path, want in modal_launches().items():
        n = by_path.get("flash_attention", {}).get(path, 0)
        require(n == want, f"flash_attention launched {n} times on the "
                f"{path} path, not {want}")
    results["flash_attention"]["extra"]["modal_shapes"] = flash_modal

    # 10. LM-zoo training: (a) the flash backward kernel, (b) CPU vs card
    # gradients, (c) smollm-135m trained at full width and (d) the other
    # masks in training; only (c)'s and (d)'s launches count
    results["flash_attention_backward"] = r = lm_train_phase(dev, gen, drive)
    for name, want in lm_train_launches().items():
        n = by_path.get(name, {}).get("zoo_train", 0)
        require(n == want, f"{name} launched {n} times on the zoo_train "
                f"path, not {want}")

    # 11. bf16 Stage 1 / Stage 2: the bf16 instances of wkv and set
    # attention, CPU vs card, and the serving, Stage-1 and Stage-2 training
    # paths at dtype "bfloat16", each with its own launch counts
    rec = bf16_phase(dev, gen, programs, blocks, intervals, cpis)
    for name in ("wkv", "wkv_backward", "set_attention",
                 "set_attention_backward"):
        results[name]["extra"]["bf16"] = rec[name]

    # 12. the bf16 k-means instances, then the k-means build, Stage-2 and
    # Stage-1 steps under a one-rank NCCL mesh, bitwise the unsharded runs
    t12 = time.perf_counter()
    km = check_bf16_kmeans(dev, gen, n_valid_build)
    for name in ("kmeans_assign", "kmeans_update"):
        results[name]["extra"]["bf16"] = km[name]
    results["kmeans_assign"]["extra"]["mesh"] = mesh_phase(
        svc, programs, intervals, cpis, drive)
    for name in ("kmeans_assign", "kmeans_update", "set_attention",
                 "set_attention_backward", "wkv", "wkv_backward"):
        require(by_path.get(name, {}).get("mesh", 0) > 0,
                f"kernel {name} was not launched on the mesh path")
    log(f"phase 12: {time.perf_counter() - t12:.1f} s")

    meta = {
        "wkv": ("src/repro_torch/csrc/wkv.cu",
                "src/repro/kernels/wkv/wkv.py:28"),
        # no TPU twin: JAX differentiates the lax.scan of wkv_scan_ref
        "wkv_backward": ("src/repro_torch/csrc/wkv.cu",
                         "src/repro/models/rwkv.py:78"),
        "set_attention": ("src/repro_torch/csrc/set_attention.cu",
                          "src/repro/kernels/set_attention/set_attn.py:68"),
        "kmeans_assign": ("src/repro_torch/csrc/kmeans.cu",
                          "src/repro/kernels/kmeans_assign/kmeans.py:32"),
        "kmeans_update": ("src/repro_torch/csrc/kmeans.cu",
                          "src/repro/kernels/kmeans_assign/kmeans.py:74"),
        "set_attention_backward": (
            "src/repro_torch/csrc/set_attention.cu",
            "src/repro/kernels/set_attention/set_attn.py:76"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/flash.py:29"),
        # no TPU twin: JAX differentiates _chunked_attention by its VJP
        "flash_attention_backward": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/models/attention.py:180"),
    }
    # each kernel's own path: serving, training for the set-attention
    # backward, Stage-1 training for the wkv backward, the zoo for flash
    own = {"set_attention_backward": "train", "flash_attention": "zoo",
           "wkv_backward": "stage1_training",
           "flash_attention_backward": "zoo_train"}
    kernels = [{
        "name": name, "route": "cuda", "source": meta[name][0],
        "replaces": meta[name][1],
        "launches": by_path[name][own.get(name, "serve")],
        "launches_by_path": by_path[name],
        "max_abs_err": r["err"], "ms": r["ms"], "wrapper_ms": r["wrapper_ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": r["library_ms"], **r.get("extra", {})}
        for name, r in results.items()]
    log("kernels: " + " ".join(f"{k['name']}={k['launches']}"
                               for k in kernels))
    log(f"whole run: {time.perf_counter() - t_run:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
