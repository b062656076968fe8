"""Load the reference package's framework-free files without importing it.

``import molvax.config`` runs ``molvax/__init__.py``, which imports JAX. The
two files the port shares with the reference, ``molvax/config.py`` (dataclasses
and typing only) and ``molvax/data/charset.py`` (numpy only), are therefore
loaded by path, under private module names, so that one preset table and one
charset stay the source of truth for both packages.

The classes loaded this way are not the objects ``molvax.config.ModelConfig``
and friends are: build each package's config from the same preset name or the
same keyword arguments, never hand one package's config to the other.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import ModuleType

_REFERENCE_ROOT = Path(__file__).resolve().parent.parent / "molvax"


def load_reference_file(relpath: str, name: str) -> ModuleType:
    """Load ``molvax/<relpath>`` as module ``molvax_torch.<name>``."""
    full = f"{__package__}.{name}"
    if full in sys.modules:
        return sys.modules[full]
    path = _REFERENCE_ROOT / relpath
    spec = importlib.util.spec_from_file_location(full, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load the shared reference file {path}")
    module = importlib.util.module_from_spec(spec)
    # dataclasses resolves string annotations through sys.modules, so the
    # module must be registered before its body runs
    sys.modules[full] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[full]
        raise
    return module
