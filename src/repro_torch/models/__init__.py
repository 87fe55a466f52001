"""The model zoo's decoders in PyTorch: global-attention, MoE,
RecurrentGemma (RG-LRU + local attention) and RWKV6 blocks (`layers`,
`kvcache`, `moe`, `rglru`, `rwkv6`, `transformer`, and `convert` to
carry weights across from the JAX package)."""
