"""Process groups for data parallelism (JAX twin dynamicrafter_tpu/parallel)."""
