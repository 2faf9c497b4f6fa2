"""Weights and state into and out of the port: flax parameter trees, the GloVe
table, d2/MSRA ResNet weights and the port's own checkpoints."""

from .checkpointer import (
    Checkpointer,
    PeriodicCheckpointerWithEval,
    d2_resnet_key_to_torch,
    load_torch_resnet,
    merge_params_from_checkpoint,
    read_checkpoint,
    resolve_own_checkpoint,
)
from .embeddings import load_glove_embeddings
from .jax_params import flax_leaves, flax_path, load_jax_params, load_jax_train_state

__all__ = [
    "Checkpointer", "PeriodicCheckpointerWithEval", "d2_resnet_key_to_torch", "flax_leaves",
    "flax_path", "load_glove_embeddings", "load_jax_params", "load_jax_train_state",
    "load_torch_resnet", "merge_params_from_checkpoint", "read_checkpoint",
    "resolve_own_checkpoint",
]
