#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code if it fails:
  1. setup: the card's name and power limit (nvidia-smi), and the build of
     the CUDA kernel library from src/repro_torch/csrc (seconds printed);
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes and at awkward ones, with its time, the plain
     version's time, one PyTorch call's time where one computes the same
     function, and the least time the card could take (bound);
  3. the full-width models on CPU (plain versions) and on the card
     (kernels) agree on a small input;
  4. the serving path at the paper's full width (default configs, k = 14,
     seeded untrained weights): 19 SPEC-like programs x 1,000 intervals,
     INORDER CPIs; ingest blocks, ingest 18 programs, build, attach_many
     the 19th, estimate every program. Every kernel must have launched.
The line before the last is the JSON kernel summary; the last line is
{"ok": true, "device": {...}}. Exits non-zero without CUDA.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): memory rate, and
# fp32 outside the tensor cores (all four kernels compute in plain fp32).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

SEED = 0
N_INTERVALS = 1000        # per program, the paper's count


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


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    fp32 operations over the fp32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
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
    # (B, S, H, dh): the encoder's shape, then dh 44 / 16 / 8 and odd S
    for B, S, H, dh, st in [(256, 128, 6, 64, False), (3, 37, 2, 44, True),
                            (2, 64, 3, 16, True), (1, 5, 1, 8, False)]:
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

    B, S, H, dh = 256, 128, 6, 64
    args = inputs(B, S, H, dh)
    ms = cuda_ms(lambda: wkv(*args), reps=20)
    plain_ms = cuda_ms(lambda: wkv_reference(*args), reps=3, warmup=1)
    n_seq = 4 * B * S * H * dh + B * S * H            # r k v w, beta
    nbytes = 4 * (n_seq + B * S * H * dh + B * H * dh * dh)   # + y, S_f
    flops = 7 * B * H * S * dh * dh
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound=bound(nbytes, flops),
                shape=f"B={B} S={S} H={H} dh={dh}")


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

    B, H, N, M, dh = 512, 4, 64, 64, 64
    q, k, v, bias, mask = inputs(B, H, N, M, dh, True, True, 24)
    ms = cuda_ms(lambda: masked_set_attention(q, k, v, bias, mask), reps=50)
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
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound=bound(nbytes, flops),
                shape=f"B={B} H={H} N={N} M={M} dh={dh}")


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


def check_kmeans_assign(dev, gen):
    from repro_torch.kernels.kmeans_assign import (
        kmeans_assign, kmeans_assign_reference,
    )
    err = 0.0
    # store capacity x 128 (clustered and uniform), then odd sizes
    for n, d, k, clustered in [(32768, 128, 14, True), (32768, 128, 14, False),
                               (1000, 64, 14, False), (513, 32, 30, False),
                               (100, 8, 4, False), (77, 200, 5, False)]:
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
    n, d, k = 32768, 128, 14
    x, c = _clustered(n, d, k, gen, dev)
    ms = cuda_ms(lambda: kmeans_assign(x, c), reps=100)
    plain_ms = cuda_ms(lambda: kmeans_assign_reference(x, c), reps=100)
    nbytes = 4 * (n * d + k * d) + 8 * n
    flops = n * (2 * k * d + 2 * d + 3 * k)
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound=bound(nbytes, flops), shape=f"N={n} d={d} K={k}")


def check_kmeans_update(dev, gen, n_valid_main: int):
    from repro_torch.kernels.kmeans_assign import (
        kmeans_update, kmeans_update_reference,
    )
    err = 0.0
    for n, d, k, holes in [(32768, 128, 14, False), (32768, 128, 14, True),
                           (1000, 64, 14, True), (513, 32, 30, False),
                           (100, 8, 4, True)]:
        x, c = _clustered(n, d, k, gen, dev)
        if holes:
            valid = (torch.rand((n,), generator=gen, device=dev) < 0.7).float()
        else:
            valid = (torch.arange(n, device=dev) < (3 * n) // 4).float()
        s, cnt, inertia = kmeans_update(x, c, valid)
        s_ref, cnt_ref, inertia_ref = kmeans_update_reference(x, c, valid)
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
    ms = cuda_ms(lambda: kmeans_update(x, c, valid), reps=100)
    plain_ms = cuda_ms(lambda: kmeans_update_reference(x, c, valid), reps=100)
    nv = n_valid_main       # only the live rows matter to the result
    nbytes = 4 * (nv * d + n + k * d) + 4 * (k * d + k + 1)
    flops = nv * (2 * k * d + 2 * d + 3 * k + d)
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound=bound(nbytes, flops),
                shape=f"N={n} (valid {nv}) d={d} K={k}")


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


def main_path(programs, blocks, intervals, cpis):
    from repro_torch.api import SemanticBBVService, ServiceConfig
    names = [p.name for p in programs]
    held_out = names[-1]
    stages = {}

    t = time.perf_counter()
    svc = SemanticBBVService.create(ServiceConfig(seed=SEED, k=14),
                                    device="cuda")
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
    require(sigs.shape == (len(names) * N_INTERVALS, 128),
            f"store holds {sigs.shape}")
    require(bool(np.isfinite(sigs).all()), "non-finite signatures")
    norms = np.linalg.norm(sigs, axis=-1)
    require(bool(np.all(np.abs(norms - 1.0) < 1e-4)),
            f"signatures not unit-norm: {norms.min()}..{norms.max()}")
    require(len(svc.bbe_table) == n_bbe == len(blocks), "BBE table size")
    require(kb.k == 14 and kb.archetypes.shape == (14, 128), "archetypes")
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
    return len(names[:-1]) * N_INTERVALS


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _lib
    from repro_torch.kernels.kmeans_assign import kmeans_assign, kmeans_update
    from repro_torch.kernels.set_attention import masked_set_attention
    from repro_torch.kernels.wkv import wkv

    # plain versions on the card must be true fp32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. setup
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    _lib.load_library()
    log(f"kernel library built and loaded in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    programs, blocks, intervals, cpis = make_world()
    log(f"world: {len(programs)} programs, {len(blocks)} blocks, "
        f"{sum(map(len, intervals.values()))} intervals "
        f"({time.perf_counter() - t:.1f} s on the host)")
    n_valid_build = (len(programs) - 1) * N_INTERVALS

    # 2. kernels against their plain versions
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    wrappers = {"wkv": wkv, "set_attention": masked_set_attention,
                "kmeans_assign": kmeans_assign, "kmeans_update": kmeans_update}
    checks = {
        "wkv": lambda: check_wkv(dev, gen),
        "set_attention": lambda: check_set_attention(dev, gen),
        "kmeans_assign": lambda: check_kmeans_assign(dev, gen),
        "kmeans_update": lambda: check_kmeans_update(dev, gen, n_valid_build),
    }
    results = {}
    for name, fn in checks.items():
        r = fn()
        results[name] = r
        lib_ms = ("null" if r["library_ms"] is None
                  else f"{r['library_ms']:.4f}")
        log(f"kernel {name} [{r['shape']}]: max_abs_err {r['err']:.3g}, "
            f"ms {r['ms']:.4f}, plain_ms {r['plain_ms']:.4f}, library_ms "
            f"{lib_ms}, bound_ms {r['bound'][0]:.4f} ({r['bound'][1]})")

    # 3. full-width CPU vs card on a small input
    cross_check_full_width(programs, intervals)

    # 4. the main path; only its launches count
    for w in wrappers.values():
        w.launches = 0
    t = time.perf_counter()
    main_path(programs, blocks, intervals, cpis)
    log(f"main path: {time.perf_counter() - t:.3f} s")
    launches = {name: w.launches for name, w in wrappers.items()}
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")

    meta = {
        "wkv": ("src/repro_torch/csrc/wkv.cu",
                "src/repro/kernels/wkv/wkv.py:28"),
        "set_attention": ("src/repro_torch/csrc/set_attention.cu",
                          "src/repro/kernels/set_attention/set_attn.py:68"),
        "kmeans_assign": ("src/repro_torch/csrc/kmeans.cu",
                          "src/repro/kernels/kmeans_assign/kmeans.py:32"),
        "kmeans_update": ("src/repro_torch/csrc/kmeans.cu",
                          "src/repro/kernels/kmeans_assign/kmeans.py:74"),
    }
    kernels = [{
        "name": name, "route": "cuda", "source": meta[name][0],
        "replaces": meta[name][1], "launches": launches[name],
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": r["library_ms"]} for name, r in results.items()]
    log("kernels: " + " ".join(f"{k['name']}={k['launches']}"
                               for k in kernels))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
