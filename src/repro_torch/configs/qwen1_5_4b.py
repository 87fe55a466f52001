"""qwen1.5-4b [dense]: 40L d2560 20H (kv=20 -> MHA) ff6912 v151936 — QKV
bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    loss_chunk=512,
    name="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
    d_ff=6912, vocab=151936, head_dim=128, qkv_bias=True,
    mlp="swiglu", pos="rope",
    attn_sharding="seq",  # 20 heads not divisible by tp=16
    skip_shapes={"long_500k": "pure full attention (DESIGN.md §4)"},
))
