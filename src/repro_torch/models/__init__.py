"""The model zoo's global-attention and MoE decoders in PyTorch
(`layers`, `kvcache`, `moe`, `transformer`, and `convert` to carry
weights across from the JAX package)."""
