"""The GRU kernels' share of their roofline in a train step, in %: the
frozen least time of the stack's forward and backward work for the traced
steps (``yardstick.gru_train_ops_per_smiles``, ``gru_train_bytes_per_step``
against the card's peaks) over the device time of the kernels whose names
match the patterns of ``gru_roofline.train.json``. Nothing where no kernel
matches or the card has no peak."""

import json
import re
from pathlib import Path

from perfbench import yardstick

PATTERNS = json.loads((Path(__file__).with_suffix(".json")).read_text())["patterns"]


def read(run):
    r, steps = run.reading, run.traced.get("steps", 0)
    if r is None or not steps:
        return None
    pat = re.compile("|".join(PATTERNS))
    seconds = sum(s for name, s in r.kernel_s.items() if pat.search(name))
    if seconds <= 0:
        return None
    rows = run.traced["smiles"] / steps
    ops = yardstick.gru_train_ops_per_smiles(run.sizes) * run.traced["smiles"]
    moved = yardstick.gru_train_bytes_per_step(run.sizes, rows) * steps
    bound = yardstick.bound_s(ops, moved, run.device_name)
    return None if bound is None else 100.0 * bound / seconds
