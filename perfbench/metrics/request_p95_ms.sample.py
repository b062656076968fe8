"""95th percentile of a request's latency in ms, by the host clock, over
the requests of the run's window after the traced ones (the profiler slows
those), taken as ``sample_p95_ms`` takes it. It stands per layer in a cell
whose tail spreads too widely from process to process to hold a bound."""

import statistics


def read(run):
    lat = run.window.get("latency_s", [])[int(run.traced.get("requests", 0)):]
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
