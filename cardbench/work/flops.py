"""Model FLOPs: the multiply-adds the model's definition needs, counted
twice (one multiply, one add), without what an implementation adds (remat's
recompute, capacity padding, idle batch rows).

A token "touches" the matmul parameters of its layers (attention's four
projections, the MLP, or the router, the dense residual FFN and its top_k
experts) and of the output head; the embedding lookup is no product.  The
causal attention products are 4 H Dh FLOPs a visible (query, key) pair.
Training counts the forward and the backward: 6 per parameter a token and
3 x the forward's attention products.
"""
from __future__ import annotations


def _attn_params(m: dict) -> int:
    d, h, kh, dh = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    return d * (h + 2 * kh) * dh + h * dh * d


def layer_params_per_token(m: dict) -> int:
    """Matmul parameters one token touches in one layer."""
    d = m["d_model"]
    mats = 3 if m.get("mlp", "swiglu") in ("swiglu", "gelu_glu") else 2
    n = _attn_params(m)
    if m.get("num_experts", 0):
        n += d * m["num_experts"]                              # router
        n += m["top_k"] * mats * d * m["d_ff"]                  # experts
        n += mats * d * m.get("dense_ff_residual", 0)           # dense FFN
    else:
        n += mats * d * m["d_ff"]
    return n


def head_params(m: dict) -> int:
    return m["d_model"] * m["vocab"]


def attn_pair_flops(m: dict) -> int:
    """FLOPs of one visible (query, key) pair over all layers (QK and PV)."""
    return 4 * m["num_heads"] * m["head_dim"] * m["num_layers"]


def causal_pairs(t: int) -> int:
    return t * (t + 1) // 2


def train_step(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step on batch x seq tokens."""
    tokens = batch * seq
    params = m["num_layers"] * layer_params_per_token(m) + head_params(m)
    return 6.0 * params * tokens + 3.0 * batch * causal_pairs(seq) * \
        attn_pair_flops(m)


def prefill(m: dict, t: int) -> float:
    """Model FLOPs of a prefill of t tokens (the head on the last one)."""
    return 2.0 * (m["num_layers"] * layer_params_per_token(m) * t
                  + head_params(m)) + causal_pairs(t) * attn_pair_flops(m)


def decode_token(m: dict, position: int) -> float:
    """Model FLOPs of one generated token at `position` (0-based): it sees
    position + 1 keys."""
    return 2.0 * (m["num_layers"] * layer_params_per_token(m)
                  + head_params(m)) + (position + 1) * attn_pair_flops(m)
