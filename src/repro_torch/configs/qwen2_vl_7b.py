"""qwen2-vl-7b [vlm]: 28L d3584 28H (GQA kv=4) ff18944 v152064 — M-RoPE,
dynamic resolution.  Backbone only: the ViT frontend is a STUB; input_specs
feeds precomputed patch/text embeddings + 3D M-RoPE positions.
[arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    loss_chunk=512,
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab=152064, head_dim=128, qkv_bias=True,
    mlp="swiglu", pos="mrope", mrope_sections=(16, 24, 24),
    embed_inputs=False,
    attn_sharding="seq",  # 28 heads not divisible by tp=16
    skip_shapes={"long_500k": "pure full attention (DESIGN.md §4)"},
))
