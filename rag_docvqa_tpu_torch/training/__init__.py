"""Training: optimizer, train step, checkpoints, the epoch loop (the
counterpart of `rag_docvqa_tpu/training`, without jax, optax or orbax)."""
