from .sample import generate, reconstruct, sample_prior

__all__ = ["generate", "reconstruct", "sample_prior"]
