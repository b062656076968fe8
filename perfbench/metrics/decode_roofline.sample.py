"""The decode's share of its roofline, in %: the frozen least time of a
request's decode (``yardstick.decode_ops_per_smiles`` per row and
``decode_bytes_per_request`` against the card's peaks) over the device's
busy time a request in the traced window. It reads no kernel names, so it
reads the same work whatever implements it."""

from perfbench import yardstick


def read(run):
    r, requests = run.reading, run.traced.get("requests", 0)
    if r is None or not requests or r.busy_s <= 0:
        return None
    rows = run.traced["smiles"] / requests
    bound = yardstick.bound_s(yardstick.decode_ops_per_smiles(run.sizes) * rows,
                              yardstick.decode_bytes_per_request(run.sizes, rows), run.device_name)
    return None if bound is None else 100.0 * bound / (r.busy_s / requests)
