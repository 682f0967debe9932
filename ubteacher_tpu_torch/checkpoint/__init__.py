from .checkpointer import TSCheckpointer
from .jax_params import params_from_jax

__all__ = ["TSCheckpointer", "params_from_jax"]
