"""The device's idle share of the traced window of whole chunks, in %:
1 - (the union of its activities' intervals) / (the window)."""


def read(run):
    r = run.reading
    if r is None or r.activities == 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
