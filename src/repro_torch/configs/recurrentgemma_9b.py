"""recurrentgemma-9b [hybrid]: 38L d4096 16H (MQA kv=1) ff12288 v256000 —
RG-LRU + local attention, pattern (rec, rec, attn).  Sub-quadratic (fixed
2048-token window) => runs long_500k. [arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    loss_chunk=512,
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256, tie_embeddings=True,
    mlp="gelu_glu", pos="rope", pattern=("rec", "rec", "attn"),
    lru_width=4096, conv_width=4, window=2048,
    attn_sharding="heads",  # 16 % 16 == 0
))
