"""Run-loop utilities: metric writers and the eval-time Conv+FrozenBN fold."""
