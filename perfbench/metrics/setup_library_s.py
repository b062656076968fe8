"""Set-up seconds loading the program's kernel library (``library``:
``kernels._build.load``, which builds it where the checkout has no build)."""

PARTS = ("library",)


def read(run):
    return run.setup_part_s(PARTS)
