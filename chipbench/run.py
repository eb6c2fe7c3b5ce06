"""Runs one cell of the benchmark once, on the card, and prints its result
as the last line of standard output.

    python3 chipbench/run.py --workload <name> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout of the repository. It loads the cell's
configuration and traffic, sets up (weights drawn from the seed on the
card, the cell's data made, every shape warmed up: `setup_s`), measures
for `--seconds`, then checks what the timed path produced against the
plain reference (`chipbench/reference/`), prints each compared number
beside its limit on standard error, and prints one JSON line:

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
     "checks"}

With `--trace 0` the metrics are the cell's end-to-end metrics; with
`--trace 1` its per-layer metrics, read from a torch.profiler trace of
the window and the benchmark's spans. Exits non-zero, printing no
result, when there is no card (or fewer than the cell needs), when the
system cannot be imported, or when JAX or the JAX package is loaded.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# caches of anything that compiles stay at fixed paths inside the
# checkout, so that only a checkout's first run builds
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "chipbench", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, "build", "chipbench", "triton"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# one process with few threads: the host's own work is what the cells
# time, and idle worker threads only contend for the cores
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from chipbench import bench
    cell = bench.Cell.find(args.workload)
    bench_json = bench.load_json(bench.ROOT / "BENCHMARK.json")

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"chipbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, lines = execute(cell, bench_json, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"chipbench: loaded in this process: {bad}", file=sys.stderr)
        return 4
    print("\n".join(lines), file=sys.stderr)
    print(json.dumps(result))
    return 0


def execute(cell, bench_json: dict, seed: int, seconds: float, trace: bool,
            device):
    """One run of `cell` on `device`: set-up, the window, the metrics and
    the check. Returns (the result line's object, the lines that give
    each compared number beside its limit)."""
    import torch
    from chipbench import bench
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    drv = bench.driver(cell.mix["kind"])
    spans = bench.Spans(traced=trace)
    job = drv.Job(cell, seed, device, spans)
    # what set-up made (weights, data, the traffic made in advance) is
    # kept out of the collector's passes in the window
    gc.collect()
    gc.freeze()
    sync()
    setup_s = time.perf_counter() - T_START
    spans.spans.clear()

    prof = None
    if trace:
        seconds = min(seconds, cell.mix["trace_seconds"])
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    with spans("window"):
        job.window(seconds)
    sync()
    gc.unfreeze()
    if prof is not None:
        prof.stop()
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    counts = job.counts()

    run = bench.Run(cell, spans, counts)
    metrics, breakdown = {}, None
    if trace:
        run.trace = bench.reduce_trace(prof)
        prof = None
        for m in bench_json["per_layer"]:
            if cell.name not in m.get("workloads", [cell.name]):
                continue
            value = bench.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": run.trace.top_ops(),
                     "idle_gaps": run.trace.idle_by_span()}
    else:
        for m in bench_json["end_to_end"]:
            if cell.name not in m.get("workloads", [cell.name]):
                continue
            value = setup_s if m["name"] == "setup_s" else counts[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    notes = job.notes()
    outputs = job.outputs()
    inputs = job.inputs()
    job.release()
    del job
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = drv.reference(cell, inputs, "fp32")
    checks = drv.compare(outputs, ref)
    notes.append(f"reference {time.perf_counter() - t0:.1f} s after the "
                 f"window of {counts['window_s']:.1f} s")

    ok = True
    lines = list(notes)
    for name, value in checks.items():
        limit = cell.limits[name]
        good = value <= limit
        ok &= good
        lines.append(f"check {name} {value!r} limit {limit!r} "
                     f"{'ok' if good else 'FAIL'}")
    result = {
        "correct": bool(ok),
        "attempted": int(counts["attempted"]),
        "failed": int(counts["failed"]),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else device.type),
                   "count": cell.chips,
                   "memory_peak_bytes": int(memory_peak)},
    }
    if trace:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": cell.limits[n]}
                        for n, v in checks.items()}
    return result, lines


if __name__ == "__main__":
    sys.exit(main())
