from .beam import beam_generate, beam_reconstruct
from .constrain import validate_codes
from .embed import decode_latents, encode_corpus
from .interpolate import interpolate, lerp, slerp
from .optimize import OptimizeResult, optimize_from_smiles, optimize_z
from .sample import fit_aggregate_posterior, generate, reconstruct, sample_aggregate, sample_prior

__all__ = [
    "beam_generate",
    "beam_reconstruct",
    "decode_latents",
    "encode_corpus",
    "interpolate",
    "lerp",
    "slerp",
    "OptimizeResult",
    "optimize_from_smiles",
    "optimize_z",
    "fit_aggregate_posterior",
    "generate",
    "reconstruct",
    "sample_aggregate",
    "sample_prior",
    "validate_codes",
]
