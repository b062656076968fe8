"""Host ms a step that the data layer waits for its pinned staging ring:
the program's span ``data.stage_wait`` (``utils.PinnedStaging.copy``, the
wait on the ring's next buffer while a copy still reads it) in the traced
window, over its steps."""


def read(run):
    return run.span_ms("molvax:data.stage_wait", "steps")
