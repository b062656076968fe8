"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), each with its plain
torch version beside it. Nothing is built at import time (``_build.py``)."""
