"""Weights into the port: flax parameter trees and the GloVe table."""

from .embeddings import load_glove_embeddings
from .jax_params import flax_leaves, flax_path, load_jax_params

__all__ = ["flax_leaves", "flax_path", "load_glove_embeddings", "load_jax_params"]
