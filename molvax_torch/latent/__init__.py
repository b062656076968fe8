from .beam import beam_generate, beam_reconstruct
from .constrain import validate_codes
from .sample import generate, reconstruct, sample_prior

__all__ = [
    "beam_generate",
    "beam_reconstruct",
    "generate",
    "reconstruct",
    "sample_prior",
    "validate_codes",
]
