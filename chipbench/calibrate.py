"""Readings that the limits of a cell's check are set from: for each
seed, the numbers the check compares for the system (its outputs
against the reference at the configuration's precision) and for the
control (the reference one precision step lower, in the system's place).
Not run by the benchmark's own runs.

    python3 chipbench/calibrate.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] [--control-seeds <k>] [--faults <name> ...]

Prints one JSON line a seed: {"seed", "setup_s", "reference_s",
"system": {...}} and, for the first k seeds, "control": {...} (the
reference in TF32) and each fault (`faulty` in the traffic kind's
module: the system's outputs with the fault planted, or the reference
with it put in the system's place).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path[:0] = [os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), p) for p in ("src", "")]


def readings(cell, seed: int, seconds: float, control: bool, device,
             faults=()):
    import time
    import torch
    from chipbench import bench
    drv = bench.driver(cell.mix["kind"])
    t0 = time.perf_counter()
    job = drv.Job(cell, seed, device, bench.Spans(False))
    setup_s = time.perf_counter() - t0
    job.window(seconds)
    got, inputs = job.outputs(), job.inputs()
    job.release()
    del job
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = drv.reference(cell, inputs, "fp32")
    out = {"seed": seed, "setup_s": setup_s,
           "reference_s": time.perf_counter() - t0,
           "system": drv.compare(got, ref)}
    if control:
        low = drv.reference(cell, inputs, "tf32")
        out["control"] = drv.compare(drv.as_outputs(got, low), ref)
    for fault in faults:
        out[fault] = drv.compare(drv.faulty(cell, got, inputs, ref, fault),
                                 ref)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=None)
    ap.add_argument("--faults", nargs="*", default=[])
    args = ap.parse_args()
    import torch
    from chipbench import bench
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = bench.Cell.find(args.workload)
    k = len(args.seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(args.seeds):
        print(json.dumps(readings(
            cell, seed, args.seconds, i < k,
            torch.device("cuda", 0), args.faults if i < k else ())),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
