"""rwkv6-7b [ssm]: 32L d4096 attention-free (Finch: data-dependent decay),
channel-mix ff14336, v65536.  64 heads of 64.  Sub-quadratic => runs
long_500k. [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    loss_chunk=512,
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=14336, vocab=65536, head_dim=64, ssm="rwkv6",
    mlp="rwkv_cm", pos="none",
))
