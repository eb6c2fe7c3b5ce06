"""What every cell of the benchmark shares: where its files are, the
spans it records around the calls into the system, the device trace of
a traced run and the reduction of that trace, and the result line.

A cell is an entry of `BENCHMARK.json`'s `workloads`: a configuration
(`configs/<config>.json`), a traffic mix (`workloads/<traffic>.json`,
whose `kind` names the driver in `drivers/<kind>.py`) and the limits of
its correctness check (`limits/<cell>.json`). A per-layer metric is read
by `metrics/<name>.py`. All are found by name; nothing here names a cell.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPAN = "chipbench."


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    chips: int

    @classmethod
    def find(cls, name: str) -> "Cell":
        bench = load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        config = load_json(ROOT / configs[w["config"]]["file"])
        mix = dict(load_json(HERE / "workloads" / f"{w['traffic']}.json"),
                   name=w["traffic"])
        limits = load_json(HERE / "limits" / f"{name}.json")
        return cls(name, config, mix, limits, int(w["chips"]))


def driver(kind: str):
    return importlib.import_module(f"chipbench.drivers.{kind}")


def reader(metric: str):
    """The `read(run)` function of `metrics/<metric>.py`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"chipbench.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Spans:
    """Host spans around calls into the system: (name, start, end)
    seconds on the host clock, and, while a trace is on, a
    `record_function` range of the same name in the trace."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.spans: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.traced:
            import torch
            with torch.profiler.record_function(SPAN + name):
                yield
        else:
            yield
        self.spans.append((name, t0, time.perf_counter()))

    def total(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.spans if n == name)

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.spans if n == name)


@dataclasses.dataclass
class Trace:
    """The device trace of a traced window, reduced: the window, every
    device operation (name, start, end) in seconds from the window's
    start, and the host spans seen in the trace."""
    window_s: float
    ops: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, inside the
        window."""
        out: List[List[float]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, 0.0), min(b, self.window_s)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def kernels(self, part: str) -> List[Tuple[str, float, float]]:
        return [o for o in self.ops if part in o[0]]

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, a, b in self.ops:
            by[name[:120]] = by.get(name[:120], 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]

    def idle_by_span(self, n: int = 10) -> List[list]:
        """Idle device time inside the window, summed by the innermost
        host span over each part of it ("outside" where none is)."""
        # the window cut at every span edge, each piece labelled by the
        # shortest span around it
        cuts = sorted({0.0, self.window_s} | {
            t for s in self.spans for t in s[1:] if 0.0 < t < self.window_s})
        pieces = []
        for lo, hi in zip(cuts, cuts[1:]):
            mid = 0.5 * (lo + hi)
            inner = [s for s in self.spans if s[1] <= mid <= s[2]]
            pieces.append((lo, hi, min(inner, key=lambda s: s[2] - s[1])[0]
                           if inner else "outside"))
        idle, last = [], 0.0
        for a, b in self.busy():
            if a > last:
                idle.append((last, a))
            last = b
        if last < self.window_s:
            idle.append((last, self.window_s))
        by: Dict[str, float] = {}
        j = 0
        for a, b in idle:
            while j < len(pieces) and pieces[j][1] <= a:
                j += 1
            k = j
            while k < len(pieces) and pieces[k][0] < b:
                lo, hi, label = pieces[k]
                by[label] = by.get(label, 0.0) + min(b, hi) - max(a, lo)
                k += 1
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]

def _ns(event, which: str) -> float:
    fn = getattr(event, f"{which}_ns", None)
    return fn() if fn is not None else getattr(event, f"{which}_us")() * 1e3


def reduce_trace(prof, window: str = SPAN + "window") -> Trace:
    """Device operations and host spans of a finished torch.profiler run,
    relative to the host span named `window`."""
    events = prof.profiler.kineto_results.events()
    host, device = [], []
    for e in events:
        name = e.name()
        if name.startswith(SPAN) and str(e.device_type()).endswith("CUDA"):
            continue            # a host span's shadow on the device's timeline
        if str(e.device_type()).endswith("CUDA"):
            start = _ns(e, "start")
            device.append((name, start, start + e.duration_ns()))
        elif name.startswith(SPAN):
            start = _ns(e, "start")
            host.append((name[len(SPAN):], start, start + e.duration_ns()))
    win = [h for h in host if h[0] == window[len(SPAN):]]
    if not win:
        raise RuntimeError("the traced window's span is not in the trace")
    t0, t1 = win[0][1], win[0][2]
    rel = lambda items: [(n, (a - t0) * 1e-9, (b - t0) * 1e-9)  # noqa: E731
                         for n, a, b in items]
    return Trace((t1 - t0) * 1e-9, rel(device),
                 rel([h for h in host if h[0] != window[len(SPAN):]]))


@dataclasses.dataclass
class Run:
    """What a run hands the metric readers."""
    cell: Cell
    spans: Spans
    counts: Dict[str, float]
    trace: Optional[Trace] = None


def quantile(values, q: float) -> float:
    """The q-quantile of values, linearly interpolated."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
