"""The benchmark's own arithmetic: the chip's peaks, and the operations and
bytes a step or an op needs, counted from shapes (never from the program)."""
