from .convert import state_dict_from_jax
