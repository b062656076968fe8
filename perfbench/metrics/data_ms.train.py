"""Host ms a step in the data layer: the benchmark's span around each
``BatchIterator.next_stack(K)`` call of the traced window, over its steps."""


def read(run):
    steps = run.traced.get("steps", 0)
    if not steps or "next_stack" not in run.spans:
        return None
    return 1e3 * run.spans["next_stack"] / steps
