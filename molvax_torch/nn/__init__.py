from .vae import MolecularVAE, encode, reparameterize

__all__ = ["MolecularVAE", "encode", "reparameterize"]
