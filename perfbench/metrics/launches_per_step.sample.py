"""Device kernels a decode step: the kernels the profiler records in the
traced window (copies and sets left out), over its requests and the T
steps of each."""


def read(run):
    r, requests = run.reading, run.traced.get("requests", 0)
    if r is None or not requests or r.activities == 0:
        return None
    return r.kernels / (requests * run.sizes["max_len"])
