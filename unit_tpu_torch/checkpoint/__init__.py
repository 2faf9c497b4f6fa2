"""Weights into the port: flax parameter trees and the GloVe table."""

from .embeddings import load_glove_embeddings
from .jax_params import load_jax_params

__all__ = ["load_glove_embeddings", "load_jax_params"]
