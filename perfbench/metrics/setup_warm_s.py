"""Set-up seconds warming the window's path: the first chunk (its capture
and the check's readings of it) and one more, or the warm requests."""

PARTS = ("first_chunk", "warm_chunk", "warm_request", "warm_requests")


def read(run):
    return run.setup_part_s(PARTS)
