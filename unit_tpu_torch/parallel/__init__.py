"""Data parallelism: one process a rank, ``torch.distributed`` collectives.

``comm`` holds the rank queries and the collectives (each a no-op in a
single process); ``launch`` starts the ranks (``launch``) or joins a group
that torchrun describes in the environment (``init_from_env``).
"""

from . import comm
from .launch import init_from_env, launch

__all__ = ["comm", "init_from_env", "launch"]
