"""Kernel experiments kept with their benches (counterparts of the JAX
repository's top-level `experiments/`)."""
