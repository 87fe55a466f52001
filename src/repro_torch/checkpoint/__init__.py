"""Checkpoints with an integrity manifest, in the JAX package's layout
(`ckpt`)."""
