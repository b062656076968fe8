"""Spans of the benchmark's own calls into the program, and the device trace.

``Spans`` times each call the harness makes into a layer of the program
(host clock) while it is on, and marks the same call in the profiler's
timeline (``pb:<name>``). The program marks its own host work there too
(``molvax:<name>``, ``molvax_torch.utils.span``). ``Session`` runs
``torch.profiler`` over a traced window and reduces it: the union of the
device's activity (kernels, copies, sets) inside the window, each kernel's
device time by name, the host seconds and count of each span of either
origin, and the idle gaps between activities, each named by the span the
host was in at its middle: by the harness's own spans alone (``idle_s``,
which the program's spans leave as it is), and by the innermost span of
either origin (``gap_s``, the breakdown's names).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "pb:"
# the program's spans (``molvax_torch.utils.SPAN_PREFIX``); read by their
# full name, where the harness's own go by the name after ``pb:``
PROGRAM = "molvax:"


class Spans:
    """Host seconds of each named span while ``on``."""

    def __init__(self):
        self.on = False
        self.seconds: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name] += time.perf_counter() - t0


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


class Reading:
    """What a traced window shows: ``window_s``, ``busy_s`` (device), kernel
    seconds and counts by name, idle seconds by the harness's span
    (``idle_s``) and by the innermost span of either origin (``gap_s``),
    and the host seconds and count of each span in the window (``span_s``,
    ``span_n``). The harness's spans go by the name after ``pb:``, the
    program's by their full ``molvax:`` name."""

    def __init__(self, window_s: float, busy_s: float, kernel_s: Dict[str, float], kernel_n: Dict[str, int],
                 idle_s: Dict[str, float], activities: int, span_s: Optional[Dict[str, float]] = None,
                 span_n: Optional[Dict[str, int]] = None, gap_s: Optional[Dict[str, float]] = None):
        self.window_s, self.busy_s = window_s, busy_s
        self.kernel_s, self.kernel_n, self.idle_s = kernel_s, kernel_n, idle_s
        self.activities = activities
        self.span_s, self.span_n = span_s or {}, span_n or {}
        self.gap_s = idle_s if gap_s is None else gap_s

    @property
    def kernels(self) -> int:
        return sum(n for name, n in self.kernel_n.items() if _is_kernel(name))

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gap_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[name[:160], s] for name, s in ops], "idle_gaps": [[name, s] for name, s in gaps]}


class Session:
    """``with Session(spans, device) as s: ...`` profiles the block; the
    block is the traced window (marked ``pb:window``); ``s.reading`` after."""

    def __init__(self, spans: Spans, device: torch.device):
        self.spans, self.device = spans, device
        self.reading: Optional[Reading] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._window = torch.profiler.record_function(PREFIX + "window")
        self._window.__enter__()
        self.spans.on = True
        return self

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __exit__(self, *exc):
        self._sync()
        self.spans.on = False
        self._window.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.reading = reduce(self._prof.events())
        self._prof = None  # the trace's events, freed before the window goes on
        return False


def _span_name(name: str) -> Optional[str]:
    """A host span's name as a reading gives it, or None for another event."""
    if name.startswith(PREFIX):
        return name[len(PREFIX):]
    return name if name.startswith(PROGRAM) else None


def _name_gaps(edges: List[float], spans: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Seconds of each idle gap (``edges``: its ends in pairs) by the name
    of the last span in ``spans``'s order that holds its middle."""
    idle: Dict[str, float] = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inside = [name for s, e, name in spans if s <= mid <= e]
        idle[inside[-1] if inside else "host:other"] += (b - a) * 1e-6
    return dict(idle)


def reduce(events) -> Reading:
    from torch.autograd import DeviceType

    window = None
    device, spans = [], []
    kernel_s: Dict[str, float] = defaultdict(float)
    kernel_n: Dict[str, int] = defaultdict(int)
    for ev in events:
        start, end = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA and (ev.name.startswith((PREFIX, PROGRAM))
                                                  or getattr(ev, "is_user_annotation", False)):
            continue  # a span's mirror on the device's timeline, not an activity
        if ev.device_type == DeviceType.CUDA:
            device.append((start, end))
            kernel_s[ev.name] += (end - start) * 1e-6
            kernel_n[ev.name] += 1
        elif ev.name == PREFIX + "window":
            window = (start, end)
        elif (name := _span_name(ev.name)) is not None:
            spans.append((start, end, name))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    w0, w1 = window
    busy = _union([(max(a, w0), min(b, w1)) for a, b in device if b > w0 and a < w1])
    busy_us = sum(b - a for a, b in busy)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    idle = _name_gaps(edges, sorted(sp for sp in spans if not sp[2].startswith(PROGRAM)))
    span_s: Dict[str, float] = defaultdict(float)
    span_n: Dict[str, int] = defaultdict(int)
    spans = [(max(s, w0), min(e, w1), name) for s, e, name in spans if e > w0 and s < w1]
    for s, e, name in spans:
        span_s[name] += (e - s) * 1e-6
        span_n[name] += 1
    # by start, the outer of two that start together first: the last that
    # holds a point is the innermost there
    gaps = _name_gaps(edges, sorted(spans, key=lambda sp: (sp[0], -sp[1])))
    return Reading((w1 - w0) * 1e-6, busy_us * 1e-6, dict(kernel_s), dict(kernel_n), idle, len(device),
                   dict(span_s), dict(span_n), gaps)
