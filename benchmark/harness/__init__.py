"""The benchmark's general code: one cell run, its traffic, its records,
its trace and its comparison with the plain reference."""
