"""The reference's native tokenizer, built once before any test asks for it.

``molvax/data/native.py`` builds ``libmolvax_tokenizer.so`` with g++ at its
first use, straight into the file it then loads. ``tests/unit/test_native.py``
asks at collection (its ``skipif``), so under pytest-xdist every worker asks
at once: on a checkout without the library each worker starts its own g++ on
the same file, and a worker that loads it half-written finds no library and
skips the six native tests. pytest collects this file before ``tests/unit/``
in every worker, so the build is settled here, at import, under an exclusive
lock on a file in the temporary directory: the first worker builds, the
others wait and then load the finished library. The loader caches its answer
in its module (``_tried`` / ``_lib``), which ``test_native.py``'s ``skipif``
then reads.
"""

import fcntl
import os
import shutil
import tempfile

from molvax.data import native

with open(os.path.join(tempfile.gettempdir(), "molvax_native_tokenizer.lock"), "w") as _lock:
    fcntl.flock(_lock, fcntl.LOCK_EX)
    try:
        native.native_available()
    finally:
        fcntl.flock(_lock, fcntl.LOCK_UN)


def test_native_tokenizer_builds_wherever_a_compiler_is_found():
    if shutil.which("g++") is not None:
        assert native.native_available()
