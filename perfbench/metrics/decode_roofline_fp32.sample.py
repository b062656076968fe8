"""The fp32 decode's share of its roofline at its own precision, in %: the
least time of a request's decode (``yardstick.decode_ops_per_smiles`` per
row at fp32's least-time rate, 3xTF32 at a third of the TF32 peak, and
``decode_bytes_per_request`` with the weights at 4 bytes a value) over the
device's busy time a request in the traced window: the work and the time
of ``decode_roofline.sample``, against the fp32 bound. It reads no kernel
names."""

from perfbench import yardstick


def read(run):
    r, requests = run.reading, run.traced.get("requests", 0)
    if r is None or not requests or r.busy_s <= 0:
        return None
    rows = run.traced["smiles"] / requests
    bound = yardstick.bound_s(yardstick.decode_ops_per_smiles(run.sizes) * rows,
                              yardstick.decode_bytes_per_request(run.sizes, rows, weight_bytes=4), run.device_name,
                              precision="fp32")
    return None if bound is None else 100.0 * bound / (r.busy_s / requests)
