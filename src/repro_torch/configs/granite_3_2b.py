"""granite-3-2b [dense]: 40L d2048 32H (GQA kv=8) ff8192 v49155 — GQA.
[hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    loss_chunk=512,
    name="granite-3-2b", family="dense",
    num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab=49155, head_dim=64, mlp="swiglu", pos="rope",
    attn_sharding="heads",  # 32 % 16 == 0
    tie_embeddings=True,
    skip_shapes={"long_500k": "pure full attention is O(L^2); 512k decode "
                              "KV at batch 1 is out of scope (DESIGN.md §4)"},
))
