"""The whole grammar sample request's share of the card's bf16 peak, in %:
the frozen least operations of a decode per SMILES
(``grammar_yardstick.decode_ops_per_smiles``) times the SMILES returned in
the traced window, over the window times the peak."""

from perfbench import grammar_yardstick, yardstick


def read(run):
    r, smiles = run.reading, run.traced.get("smiles", 0)
    peak = yardstick.peak(run.device_name, "bf16_flops")
    if r is None or not smiles or peak is None:
        return None
    return 100.0 * grammar_yardstick.decode_ops_per_smiles(run.sizes) * smiles / (r.window_s * peak)
