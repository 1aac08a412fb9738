"""The benchmark of flatmatch_tpu_torch: the harness, its reference and its
metric readers. It imports nothing of JAX or of the JAX package."""
