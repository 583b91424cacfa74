"""Data and spatial parallelism (port of m3d/parallel)."""
