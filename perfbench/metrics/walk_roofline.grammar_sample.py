"""The pushdown walk's share of its roofline, in %: the least time of the
walks of the traced window (``grammar_yardstick.walk_bytes_per_smiles`` a
SMILES, at the card's memory rate; the walk does no products) over the
device time of the kernels whose names match the patterns of
``walk_roofline.grammar_sample.json``. Nothing where no kernel matches or
the card has no peak."""

import json
import re
from pathlib import Path

from perfbench import grammar_yardstick, yardstick

PATTERNS = json.loads((Path(__file__).with_suffix(".json")).read_text())["patterns"]


def read(run):
    r, smiles = run.reading, run.traced.get("smiles", 0)
    rate = yardstick.peak(run.device_name, "hbm_bytes_s")
    if r is None or not smiles or rate is None:
        return None
    pat = re.compile("|".join(PATTERNS))
    seconds = sum(s for name, s in r.kernel_s.items() if pat.search(name))
    if seconds <= 0:
        return None
    return 100.0 * grammar_yardstick.walk_bytes_per_smiles(run.sizes) * smiles / rate / seconds
