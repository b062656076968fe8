"""Host ms a request in the decode graph's replay: the program's span
``sample.replay`` (``latent.sample.CapturedDecode.replay``: z's and the
seed's copies into the graph's inputs and ``graph.replay()``) in the traced
window, over its requests. It reads the traced cost: under the profiler a
graph's launch holds the host longer than untraced, where the same call's
host time is ``tests/test_pb_card.py``'s to read."""


def read(run):
    return run.span_ms("molvax:sample.replay", "requests")
