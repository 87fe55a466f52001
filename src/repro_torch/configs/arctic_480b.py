"""arctic-480b [moe]: 35L d7168 56H (GQA kv=8) ff4864 v32000, MoE 128e top-2
PLUS a parallel dense-FFN residual path — the closest structural analogue of
the paper's base-ISA + swappable-extensions split (DESIGN.md §4).
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    loss_chunk=512,
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab=32000, head_dim=128,
    num_experts=128, top_k=2, moe_every=1, dense_ff_residual=4864,
    mlp="swiglu", pos="rope",
    attn_sharding="seq",  # 56 heads not divisible by tp=16
    skip_shapes={"long_500k": "pure full attention (DESIGN.md §4)"},
))
