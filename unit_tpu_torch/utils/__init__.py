"""Run-loop utilities: metric writers, the eval-time Conv+FrozenBN fold,
PreciseBN and the profiler hooks."""
