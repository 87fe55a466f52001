"""The model zoo's global-attention decoders in PyTorch (`layers`,
`kvcache`, `transformer`, and `convert` to carry weights across from the
JAX package)."""
