"""The program's own spans (`repro_torch.utils.spans`, recorded while the
traced window's profiler runs) on the device trace's clock, for the
per-layer metrics that read them.

The program stamps its spans with `time.perf_counter_ns()`, the clock of
the benchmark's `Spans`; the trace gives the same benchmark spans on the
profiler's clock, from the window's start. A least-squares offset and
rate over the edges of those spans (the window's included) maps every
program span onto the trace's timeline; `residual_s` is the fit's
largest miss. Spans are cut to the window, so a process that ran
another traced window before keeps that window's records out.

The device's idle time is put down to the innermost program span over
each idle piece, else to the innermost benchmark span, else to
"outside". A program that records no spans (one from before they
existed) reads as nothing: every reader returns None.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

Piece = Tuple[str, float, float]        # (name, start, end) on the trace


def _recorded():
    """(records, dropped) of the program's recorder, or None where the
    program has none."""
    try:
        spans = importlib.import_module("repro_torch.utils.spans")
    except ModuleNotFoundError as e:
        if e.name not in ("repro_torch", "repro_torch.utils",
                          "repro_torch.utils.spans"):
            raise
        return None
    return spans.records(), spans.dropped()


@dataclasses.dataclass
class View:
    """A traced run's program spans on the trace's clock, cut to the
    window: (name, start, end, counts) in seconds from its start."""
    spans: List[Tuple[str, float, float, dict]]
    residual_s: float
    idle: Dict[str, float]

    def named(self, *names: str) -> list:
        return [s for s in self.spans if s[0] in names]

    def count(self, name: str) -> int:
        return len(self.named(name))

    def total(self, name: str) -> float:
        return sum(b - a for _, a, b, _ in self.named(name))

    def counted(self, name: str, key: str) -> int:
        return sum(c.get(key, 0) for _, _, _, c in self.named(name))

    def idle_under(self, prefix: str, but: Tuple[str, ...] = ()) -> float:
        """Idle device seconds put down to spans named `prefix`..., other
        than those in `but`."""
        return sum(v for k, v in self.idle.items()
                   if k.startswith(prefix) and k not in but)


def _pairs(run) -> List[Tuple[float, float]]:
    """(host clock, trace clock) of each edge of a benchmark span seen on
    both, the window's included: the k-th span of a name on the host is
    the k-th of that name in the trace."""
    host = [s for s in run.spans.spans if s[0] != "window"]
    window = [s for s in run.spans.spans if s[0] == "window"][-1]
    out = [(window[1], 0.0), (window[2], run.trace.window_s)]
    by_name: Dict[str, list] = {}
    for s in sorted(run.trace.spans, key=lambda s: s[1]):
        by_name.setdefault(s[0], []).append(s)
    mine: Dict[str, list] = {}
    for s in host:
        mine.setdefault(s[0], []).append(s)
    for name, hs in mine.items():
        ts = by_name.get(name, [])
        if len(ts) != len(hs):
            continue
        for h, t in zip(hs, ts):
            out += [(h[1], t[1]), (h[2], t[2])]
    return out


def fit(pairs: List[Tuple[float, float]]) -> Tuple[float, float, float]:
    """(offset, rate, largest residual) of trace = offset + rate x (host -
    the first pair's host time), by least squares."""
    x0 = pairs[0][0]
    xs = [h - x0 for h, _ in pairs]
    ys = [t for _, t in pairs]
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    rate = (sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
            if sxx > 0 else 1.0)
    offset = my - rate * mx
    residual = max(abs(offset + rate * x - y) for x, y in zip(xs, ys))
    return offset - rate * x0, rate, residual


def idle_by_innermost(idle: List[Tuple[float, float]], program: List[Piece],
                      bench: List[Piece]) -> Dict[str, float]:
    """Idle seconds by the innermost span over each idle piece: the open
    program span that started last, else the open benchmark span that
    started last, else "outside". One sweep over the sorted edges."""
    events = []
    for kind, spans in ((0, program), (1, bench)):
        for i, (_, a, b) in enumerate(spans):
            if b > a:       # of two that start together, the longer first
                events.append((a, 1, -b, kind, i))
                events.append((b, 0, 0.0, kind, i))
    events.sort()
    stacks: Tuple[list, list] = ([], [])
    by: Dict[str, float] = {}
    j, t = 0, float("-inf")

    def label() -> str:
        for kind, spans in ((0, program), (1, bench)):
            if stacks[kind]:
                return spans[stacks[kind][-1]][0]
        return "outside"

    def credit(lo: float, hi: float) -> None:
        # idle time in [lo, hi), all of it under one label
        nonlocal j
        if hi <= lo:
            return
        while j < len(idle) and idle[j][1] <= lo:
            j += 1
        k, got = j, 0.0
        while k < len(idle) and idle[k][0] < hi:
            got += min(hi, idle[k][1]) - max(lo, idle[k][0])
            k += 1
        if got > 0:
            name = label()
            by[name] = by.get(name, 0.0) + got

    for time, opens, _, kind, i in events:
        credit(t, time)
        t = time
        stack = stacks[kind]
        if opens:
            stack.append(i)
        elif stack and stack[-1] == i:
            stack.pop()
        else:
            stack.remove(i)
    credit(t, float("inf"))
    return by


def _idle(trace) -> List[Tuple[float, float]]:
    out, last = [], 0.0
    for a, b in trace.busy():
        if a > last:
            out.append((last, a))
        last = b
    if last < trace.window_s:
        out.append((last, trace.window_s))
    return out


def view(run) -> Optional[View]:
    """The program's spans of a traced run on the trace's clock, computed
    once a run; None when the program recorded none in the window or
    lost some of them."""
    cache = run.__dict__
    if "program_spans" not in cache:
        cache["program_spans"] = _view(run, _recorded())
    return cache["program_spans"]


def _view(run, recorded) -> Optional[View]:
    if recorded is None or run.trace is None:
        return None
    records, dropped = recorded
    if not any(s[0] == "window" for s in run.spans.spans):
        return None
    offset, rate, residual = fit(_pairs(run))
    w = run.trace.window_s
    if dropped and records and offset + rate * records[0].end_ns * 1e-9 > 0:
        return None         # records of this window were pushed out
    spans = []
    for r in records:
        a = offset + rate * r.start_ns * 1e-9
        b = offset + rate * r.end_ns * 1e-9
        if b > 0 and a < w:
            spans.append((r.name, max(a, 0.0), min(b, w), r.counts))
    if not spans:
        return None
    idle = idle_by_innermost(_idle(run.trace),
                             [s[:3] for s in spans], run.trace.spans)
    return View(spans, residual, idle)
