"""minitron-4b [dense]: 32L d3072 24H (GQA kv=8) ff9216 v256000 — pruned
nemotron. [arXiv:2407.14679; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    loss_chunk=512,
    name="minitron-4b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=9216, vocab=256000, head_dim=128, tie_embeddings=True,
    mlp="swiglu", pos="rope",
    attn_sharding="seq",  # 24 heads not divisible by tp=16
    skip_shapes={"long_500k": "pure full attention (DESIGN.md §4)"},
))
