"""The benchmark's cells cut to sizes a CPU test holds (every width cut:
these are not the cells, only their code paths)."""
from __future__ import annotations

import copy

from cardbench import spec

TRAIN = "granite-3-2b.train-4x1024"
SERVE = "arctic-480b-2l.prefill-long"


def cell(name: str, dtype: str = "float32"):
    c = copy.deepcopy(spec.cell(name))
    m = dict(c.config["model"])
    if c.traffic["kind"] == "train":
        m.update(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                 head_dim=16, d_ff=128, vocab=256, dtype=dtype,
                 loss_chunk=16)
        c.traffic.update(batch=2, seq=32)
    else:
        m.update(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                 head_dim=16, d_ff=32, vocab=256, num_experts=8,
                 dense_ff_residual=32, dtype=dtype)
        c.traffic.update(batch=4, max_len=128, clients=4, stagger_steps=2,
                         prompt_len={"lo": 16, "hi": 64, "pool": 8},
                         new_tokens={"lo": 8, "hi": 24, "pool": 8},
                         sample_tokens=64)
    c.config["model"] = m
    return c
