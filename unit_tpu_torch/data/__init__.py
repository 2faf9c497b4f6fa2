"""Host-side data transforms (port of the test side of unit_tpu.data.transforms)."""
