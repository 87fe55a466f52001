"""llama4-maverick-400b-a17b [moe]: 48L d5120 40H (GQA kv=8) expert ff8192
v202048, MoE 128e top-1, MoE on alternating layers (=> ~400B total / ~17B
active).  Early-fusion multimodality is a frontend concern and out of the
backbone scope. [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    loss_chunk=512,
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    num_experts=128, top_k=1, moe_every=2,
    mlp="swiglu", pos="rope",
    attn_sharding="seq",  # 40 heads not divisible by tp=16
    skip_shapes={"long_500k": "pure full attention (DESIGN.md §4)"},
))
