"""One card's share of its bf16 peak in a data-parallel train step, in %:
the frozen least operations of a step (``yardstick.train_ops_per_smiles``)
times rank 0's own SMILES in its traced window (every rank's over the
ranks), over rank 0's window times the peak."""

from perfbench import yardstick


def read(run):
    r, smiles = run.reading, run.traced.get("smiles", 0)
    peak = yardstick.peak(run.device_name, "bf16_flops")
    if r is None or not smiles or peak is None:
        return None
    return 100.0 * yardstick.train_ops_per_smiles(run.sizes) * (smiles / run.world) / (r.window_s * peak)
