"""qwen1.5-110b [dense]: 80L d8192 64H (GQA kv=8) ff49152 v152064 — QKV bias.
[hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    loss_chunk=512,
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=49152, vocab=152064, head_dim=128, qkv_bias=True,
    mlp="swiglu", pos="rope", attn_sharding="heads",  # 64 % 16 == 0
    skip_shapes={"long_500k": "pure full attention (DESIGN.md §4)"},
))
