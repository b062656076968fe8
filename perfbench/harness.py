"""One run of one cell: set-up, the measured window, the check, the metrics.

``run_cell`` is the whole of a run in one process (one rank of a
multi-chip cell: ``ranks.py`` starts them). The cell's traffic kind
(``traffic/<kind>.py``) provides ``setup``, ``window``, ``release`` and
``check``, and may provide ``first_use`` (set-up run before the profiler's
start); the harness times the set-up from the process's start to the
window's, and its parts (``Context.part``), reads the device's peak memory
after the window and before the check, and reads each per-layer metric
with its own reader (``metrics/<metric>.py``, ``read(run)``; None where it
finds nothing) from the traced window, the window's own readings and the
set-up's parts.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed

from . import spec
from .trace import Reading, Session, Spans


@dataclasses.dataclass
class Context:
    name: str
    cell: dict
    conf: dict
    sizes: dict
    mix: dict
    cfg: Any
    seed: int
    device: torch.device
    mesh: Any = None
    rank: int = 0
    world: int = 1
    spans: Spans = dataclasses.field(default_factory=Spans)
    parts: Dict[str, float] = dataclasses.field(default_factory=dict)
    state: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def agreed(self, flag: bool) -> bool:
        """``flag`` on any rank: a decision every rank takes together, so
        that all make the same collective calls (one rank: ``flag``)."""
        if self.world == 1:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX, group=self.mesh.host_group)
        return bool(t.item())

    def part(self, name: str, t0: float) -> float:
        """Record set-up part ``name`` as the seconds since ``t0``; returns now."""
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - t0
        return now


class TraceWindow:
    """The traced part of a window: the first ``units`` units of work (the
    mix's ``trace_units``) under the profiler, when the run traces.
    ``paused`` is the seconds that the profiler's start and stop (reading
    the trace) took; a window leaves them out of its length, so that a
    traced run still has its ``--seconds`` of work, the rest untraced."""

    def __init__(self, ctx: Context, on: bool):
        self.ctx, self.on = ctx, on
        self.units = int(ctx.mix["trace_units"])
        self.session: Optional[Session] = None
        self.done = 0
        self.extra: Dict[str, float] = {}
        self.paused = 0.0

    def before(self, i: int) -> None:
        if self.on and i == 0:
            t0 = time.perf_counter()
            self.session = Session(self.ctx.spans, self.ctx.device).__enter__()
            self.paused += time.perf_counter() - t0

    def after(self, i: int, **counts) -> None:
        if self.session is None or self.session.reading is not None or self.done >= self.units:
            return
        self.done += 1
        for k, v in counts.items():
            self.extra[k] = self.extra.get(k, 0) + v
        if self.done == self.units:
            t0 = time.perf_counter()
            self.session.__exit__(None, None, None)
            self.paused += time.perf_counter() - t0

    def close(self) -> None:
        if self.session is not None and self.session.reading is None:
            self.session.__exit__(None, None, None)

    @property
    def reading(self) -> Optional[Reading]:
        return None if self.session is None else self.session.reading


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads."""

    sizes: dict
    device_name: str
    reading: Optional[Reading]
    traced: Dict[str, float]  # counts of the traced window (units, steps, smiles, requests)
    spans: Dict[str, float]  # host seconds of each span in the traced window
    window: Dict[str, Any]  # the whole window's own readings (each request's latency), traced units first
    parts: Dict[str, float] = dataclasses.field(default_factory=dict)  # the set-up's parts, seconds
    world: int = 1  # the ranks of the cell; a reading is rank 0's

    def span_ms(self, name: str, unit: str) -> Optional[float]:
        """Host ms of the traced window's spans ``name`` (``Reading.span_s``)
        a traced ``unit`` ('steps', 'requests'); None where the window holds
        none of them or no such unit."""
        units = self.traced.get(unit, 0)
        if self.reading is None or not units or name not in self.reading.span_s:
            return None
        return 1e3 * self.reading.span_s[name] / units

    def setup_part_s(self, names) -> Optional[float]:
        """Seconds of the set-up's parts ``names`` together; None where it has none of them."""
        got = [self.parts[n] for n in names if n in self.parts]
        return sum(got) if got else None


def traffic_module(kind: str):
    return importlib.import_module(f"{__package__}.traffic.{kind}")


def metric_reader(name: str):
    path = spec.PKG / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"{__package__}.metrics_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def make_context(name: str, seed: int, device, mesh=None, rank: int = 0, world: int = 1) -> Context:
    cell = spec.cell(name)
    conf = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    t0 = time.perf_counter()
    cfg = spec.program_config(conf)
    ctx = Context(name, cell, conf, conf["sizes"], mix, cfg, seed, torch.device(device), mesh, rank, world)
    ctx.part("config", t0)
    return ctx


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda", t_start: Optional[float] = None,
             mesh=None, rank: int = 0, world: int = 1, parts: Optional[Dict[str, float]] = None) -> dict:
    """One run of cell ``name``: the result's fields, the checks as
    (name, value, limit), the set-up's parts and ``setup_s``. ``t_start``:
    the ``time.perf_counter()`` of the process's start (default: now);
    ``parts``: those of the set-up's parts that the caller timed before."""
    t_start = time.perf_counter() if t_start is None else t_start
    t0 = time.perf_counter()
    # one host thread: the idle workers of a pool spin on the cores that the
    # launch loop and the string decode need, and the tails spread with them
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    cuda_init = time.perf_counter() - t0
    ctx = make_context(name, seed, dev, mesh, rank, world)
    ctx.parts.update(parts or {})
    ctx.parts["cuda_init"] = ctx.parts.get("cuda_init", 0.0) + cuda_init
    kind = traffic_module(ctx.mix["kind"])
    # set-up work that the profiler's first start would do first, and so take
    # into its own part in a traced run, done before it, in every run
    first_use = getattr(kind, "first_use", None)
    if first_use is not None:
        first_use(ctx)
    if trace:  # the profiler's first start takes seconds: once here, not in the window
        t0 = time.perf_counter()
        with Session(Spans(), dev):
            ctx.sync()
        ctx.part("profiler_init", t0)
    kind.setup(ctx)
    ctx.sync()
    # what set-up made (the modules, the weights) moves out of the collector's
    # reach, so a full collection in the window walks only the window's objects
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    tw = TraceWindow(ctx, trace)
    out = kind.window(ctx, seconds, tw)
    tw.close()
    ctx.sync()
    gc.unfreeze()
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind.release(ctx)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks: List[Tuple[str, float, float]] = kind.check(ctx) if rank == 0 else []
    values = dict(out["metrics"], setup_s=setup_s)
    if trace:
        reading = tw.reading
        run = Run(ctx.sizes, device_name(dev), reading, tw.extra, dict(ctx.spans.seconds), out.get("readings", {}),
                  dict(ctx.parts), world)
        metrics = {}
        for m in spec.metrics(name, True):
            v = metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.metrics(name, False) if m["name"] in values}
    return {
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "memory_peak_bytes": memory,
        "reading": tw.reading,
        "checks": checks,
        "parts": dict(ctx.parts),
        "setup_s": setup_s,
        "traced": dict(tw.extra),
        "notes": out.get("notes", {}),
        "device": device_name(dev),
    }


def correct(checks: List[Tuple[str, float, float]]) -> bool:
    """Every number within its limit (a number that is not finite never is)."""
    return bool(checks) and all(math.isfinite(v) and v <= limit for _, v, limit in checks)
