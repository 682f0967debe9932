from .jax_params import params_from_jax

__all__ = ["params_from_jax"]
