from .convert import jax_from_state_dict, load_npz, save_npz, state_dict_from_jax

__all__ = ["jax_from_state_dict", "load_npz", "save_npz", "state_dict_from_jax"]
