"""Host ms a request in the string decode: the program's span
``sample.strings`` (``latent.sample._decode_over``: the host codes to
strings, or the walk's terminal lookup) in the traced window, over its
requests."""


def read(run):
    return run.span_ms("molvax:sample.strings", "requests")
