"""musicgen-medium [audio]: 48L d1536 24H (MHA kv=24) ff6144 v2048 —
decoder-only over EnCodec tokens.  The EnCodec frontend is a STUB:
input_specs feeds precomputed frame embeddings; the backbone predicts
codebook tokens.  (Positional encoding adapted to RoPE; see DESIGN.md.)
[arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    loss_chunk=512,
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab=2048, head_dim=64, embed_inputs=False,
    mlp="gelu", pos="rope",
    attn_sharding="seq",  # 24 heads not divisible by tp=16
    skip_shapes={"long_500k": "pure full attention (DESIGN.md §4)"},
))
