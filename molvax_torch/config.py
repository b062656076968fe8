"""Config tree and presets: the reference's own table, shared by file path.

Everything here is ``molvax/config.py`` itself, loaded without JAX
(``_shared.py``). The routing flags keep their meaning in the port:
``use_pallas_generation`` means "hand-written generation kernel on"
(``kernels/generate.py``); ``compute_dtype`` resolves per device
(``utils.matmul_dtype``).
"""

from __future__ import annotations

from ._shared import load_reference_file

_ref = load_reference_file("config.py", "_shared_config")

ModelConfig = _ref.ModelConfig
KLScheduleConfig = _ref.KLScheduleConfig
TrainConfig = _ref.TrainConfig
DataConfig = _ref.DataConfig
MeshConfig = _ref.MeshConfig
Config = _ref.Config
PRESETS = _ref.PRESETS
get_preset = _ref.get_preset
apply_overrides = _ref.apply_overrides
to_dict = _ref.to_dict
from_dict = _ref.from_dict

__all__ = [
    "ModelConfig",
    "KLScheduleConfig",
    "TrainConfig",
    "DataConfig",
    "MeshConfig",
    "Config",
    "PRESETS",
    "get_preset",
    "apply_overrides",
    "to_dict",
    "from_dict",
]
