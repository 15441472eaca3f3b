"""Data subsystem: offline prep (KITTI-format infos + GT database), host
augmentation pipeline, GT-database sampler, batch loader, streaming sources
and a synthetic dataset generator for tests and benchmarks. NumPy copies of
the JAX package's modules; only ``stream.py`` touches torch."""
