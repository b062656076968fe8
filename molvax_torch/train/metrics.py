"""Structured metrics logging (JSONL and a console line).

Port of ``molvax/train/metrics.py``. The metrics of a step are 0-d tensors
on the model's device; a log pulls the whole dict to the host in one copy
(``torch.stack`` of the values, then one ``.cpu()``), not one ``.item()``
per key, so a log waits for the device once.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, List, Optional, TextIO

import torch


def host_values(metrics: Dict) -> Dict[str, float]:
    """{name: float} of a dict of 0-d tensors on one device (and numbers,
    taken as they are): the tensors in one copy."""
    tensors = {k: v for k, v in metrics.items() if isinstance(v, torch.Tensor)}
    out = {k: float(v) for k, v in metrics.items() if k not in tensors}
    if tensors:
        vals = torch.stack([v.detach().float().reshape(()) for v in tensors.values()]).cpu().tolist()
        out.update(zip(tensors, vals))
    return {k: out[k] for k in metrics}


def host_rows(stacked: Dict[str, torch.Tensor]) -> List[Dict[str, float]]:
    """The per-step dicts of a chunk's stacked (K,) metrics, in one copy."""
    names = list(stacked)
    table = torch.stack([stacked[k].detach().float() for k in names]).cpu().tolist()
    return [dict(zip(names, col)) for col in zip(*table)]


class MetricsLogger:
    """Appends one JSON line per log to ``path`` (when given) and prints a
    brief line to ``stream`` (stderr by default; False for none)."""

    def __init__(self, path: Optional[str] = None, stream: Optional[TextIO] = None):
        self._file = open(path, "a") if path else None
        self._stream = stream if stream is not None else sys.stderr
        self._t0 = time.perf_counter()

    def log(self, step: int, metrics: Dict, extra: Optional[Dict] = None) -> Dict:
        host = host_values(metrics)
        host["step"] = int(step)
        host["wall_s"] = round(time.perf_counter() - self._t0, 3)
        if extra:
            host.update(extra)
        line = json.dumps(host, sort_keys=True)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._stream:
            brief = " ".join(f"{k}={host[k]:.4g}" for k in ("loss", "recon", "kl", "beta", "acc") if k in host)
            if not brief:  # e.g. eval_-prefixed dicts: print them all
                brief = " ".join(f"{k}={v:.4g}" for k, v in sorted(host.items()) if k not in ("step", "wall_s"))
            print(f"[molvax] step {step}: {brief}", file=self._stream)
        return host

    def close(self) -> None:
        if self._file:
            self._file.close()


def device_metrics_ready(metrics: Dict) -> Dict:
    """Wait until the device has computed ``metrics`` (for benchmarking and
    the end of a run); returns them."""
    devices = {v.device for v in metrics.values() if isinstance(v, torch.Tensor) and v.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return metrics
