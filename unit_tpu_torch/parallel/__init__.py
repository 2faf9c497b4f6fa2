"""Data parallelism, FSDP and TP: one process a rank, ``torch.distributed``.

``comm`` holds the rank queries, the data rank, and the collectives over
the world or a given group (each a no-op in a single process);
``launch`` starts the ranks (``launch``) or joins a group that torchrun
describes in the environment (``init_from_env``); ``mesh`` builds the
device meshes and splits a model for FSDP or TP, and ``tensor`` holds the
column-parallel layers of TP (both imported as submodules).
"""

from . import comm
from .launch import init_from_env, launch

__all__ = ["comm", "init_from_env", "launch"]
