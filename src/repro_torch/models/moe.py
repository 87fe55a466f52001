"""Mixture-of-Experts layer: PyTorch port of `repro.models.moe` on one
device.

Token order is deterministic (first-come capacity, paper-faithful
"first-served slots"): a token's k routed experts each take the next free
row of that expert's capacity buffer, and assignments past the capacity
are dropped.  The dispatch is a torch gather/scatter; the expert FFN runs
the grouped-FFN kernels of `repro_torch.kernels.moe_gmm`, which the JAX
model never calls (its `_expert_ffn` is three einsums over all experts):
`moe_gmm` at prefill and in training, where nearly every expert is live,
and `moe_gmm_skip` at a decode step, where a few are, so the weights of
empty experts are never read.  An empty expert's buffer is all zeros and
its output is zero either way, so both compute the JAX model's function.

The paper hook: the per-layer expert load vector (`aux["expert_load"]`)
is the opcode-access set of `repro_torch.core.expert_slots`; the serving
engine feeds it to the disambiguator to track slot residency and fills.

Not here: the expert-parallel path (`moe_apply_sharded`, a TPU-mesh
`shard_map` with `MOE_TOKEN_CHUNK` chunking) has no meaning on one card,
and `moe_apply` with a mesh raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.expert_slots import topk_stable
from repro_torch.kernels import moe_gmm as _gmm

__all__ = ["init_moe", "route", "moe_apply_dense", "moe_apply"]


def init_moe(gen: torch.Generator, cfg, layers: int, device="cuda"):
    """Random router and expert weights of `layers` layers, each leaf
    stacked over them, with the JAX package's per-layer shapes, dtypes
    and scales; the router stays float32 whatever `cfg.dtype`.  Each leaf
    is drawn one layer at a time in place, in the working dtype: one
    (E, D, F) expert tensor of arctic-480b is 8.9 GB in bf16, and neither
    an f32 draw nor a stacking copy of it would fit beside the rest."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def normal(shape, dtype, scale):
        out = torch.empty((layers, *shape), dtype=dtype, device=device)
        for i in range(layers):
            out[i].normal_(generator=gen).mul_(scale)
        return out

    dt = cfg.torch_dtype
    return {"router": normal((d, e), torch.float32, d ** -0.5),
            "wi": normal((e, d, f), dt, d ** -0.5),
            "wg": normal((e, d, f), dt, d ** -0.5),
            "wo": normal((e, f, d), dt, f ** -0.5)}


def _capacity(n_tokens: int, cfg) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def route(x2d: torch.Tensor, router_w: torch.Tensor, cfg,
          router_bias: torch.Tensor | None = None):
    """x2d: (N, D) -> expert ids (N, k), gates (N, k) f32.

    router_bias (E,) implements *slot-hit routing*: the serving engine
    biases selection toward slot-resident experts; gates are renormalised
    from the UNBIASED logits so mixture weights stay faithful to the
    learned router.  Ties go to the lower expert id, as `jax.lax.top_k`."""
    logits = x2d.float() @ router_w
    sel = logits if router_bias is None else logits + router_bias
    _, ids = topk_stable(sel, cfg.top_k)
    orig = torch.gather(logits, -1, ids)
    gates = torch.softmax(orig, dim=-1)
    return ids, gates


def _dispatch_indices(ids: torch.Tensor, n_experts: int, capacity: int):
    """First-come positions within each expert's capacity buffer.

    ids: (N, k) -> (pos (N, k) int32, kept (N, k) bool).
    """
    n, k = ids.shape
    flat = ids.reshape(-1).long()                            # (N*k,)
    # `F.one_hot` without it: one_hot checks the ids on the host on the
    # CPU and lowers differently on each device, this is the same ops
    # everywhere (the cost counter's counts do not depend on the device)
    onehot = (flat[:, None] == torch.arange(
        n_experts, device=flat.device)).to(torch.int32)
    pos = torch.cumsum(onehot, 0, dtype=torch.int32) - onehot   # exclusive
    pos = torch.gather(pos, 1, flat[:, None])[:, 0]
    kept = pos < capacity
    return pos.reshape(n, k), kept.reshape(n, k)


def _expert_ffn(buf, wi, wg, wo, cfg, counts=None, use_kernel=None):
    """buf (E, C, D) through the stacked experts: `moe_gmm`, or with
    `counts` (E,) int32 `moe_gmm_skip`, which skips the empty experts."""
    if cfg.mlp == "swiglu":
        w_first, gated = wg, True
    elif cfg.mlp == "gelu":
        w_first, gated = wi, False     # the kernel's ungated form reads wg
    else:
        raise NotImplementedError(
            f"MoE mlp {cfg.mlp!r}: the grouped-FFN kernel computes the "
            f"silu-gated ('swiglu') or the ungated gelu ('gelu') FFN only")
    if counts is None:
        return _gmm.moe_gmm(buf, w_first, wi, wo, gated=gated,
                            use_kernel=use_kernel)
    return _gmm.moe_gmm_skip(buf, w_first, wi, wo, counts, gated=gated,
                             use_kernel=use_kernel)


def _gather_compute_scatter(x2d, ids, gates, pos, kept, wi, wg, wo, cfg,
                            capacity: int, counts=None, use_kernel=None):
    """Dispatch the kept assignments into the experts' capacity buffers,
    run the expert FFN and return the gated sum (N, D).

    The JAX package scatter-adds every assignment, the dropped ones as
    zeros at (0, 0); here only the kept rows are written, whose (expert,
    position) pairs are unique, which gives the same buffer with no
    accumulation.  The dropped ones go to one spare row past the buffer,
    so the layer never waits on the host for a count.  (The JAX
    function's `e_lo`/`e_local` select one shard's experts under the
    expert-parallel mesh; one card holds them all.)"""
    n, d = x2d.shape
    e, k = cfg.num_experts, ids.shape[1]
    e_loc = torch.where(kept, ids, 0).reshape(-1)
    p_loc = torch.where(kept, pos, 0).reshape(-1)
    w = kept.to(x2d.dtype)

    flat = torch.zeros((e * capacity + 1, d), dtype=x2d.dtype,
                       device=x2d.device)
    slot = torch.where(kept.reshape(-1), e_loc * capacity + p_loc,
                       e * capacity)
    flat[slot] = x2d.repeat_interleave(k, dim=0)
    buf = flat[:-1].view(e, capacity, d)

    out_buf = _expert_ffn(buf, wi, wg, wo, cfg, counts, use_kernel)

    y = out_buf.reshape(-1, d)[e_loc * capacity + p_loc].reshape(n, k, d)
    y = y * (gates.to(x2d.dtype) * w)[..., None]
    return y.sum(dim=1)


def moe_apply_dense(p, x, cfg, router_bias=None, *, skip_empty=False,
                    use_kernel=None):
    """Single-device path.  `skip_empty` (a decode step) runs the expert
    FFN through `moe_gmm_skip` with the per-expert kept counts, which stay
    on the device."""
    b, t, d = x.shape
    x2d = x.reshape(-1, d)
    cap = _capacity(x2d.shape[0], cfg)
    ids, gates = route(x2d, p["router"], cfg, router_bias)
    pos, kept = _dispatch_indices(ids, cfg.num_experts, cap)
    load = torch.zeros((cfg.num_experts,), dtype=torch.int32,
                       device=x.device).index_add_(
        0, ids.reshape(-1), kept.reshape(-1).to(torch.int32))
    y = _gather_compute_scatter(
        x2d, ids, gates, pos, kept, p["wi"], p["wg"], p["wo"], cfg, cap,
        load if skip_empty else None, use_kernel)
    return y.reshape(b, t, d), {"expert_load": load}


def moe_apply(p, x, cfg, mesh=None, router_bias=None, *, skip_empty=False,
              use_kernel=None):
    if mesh is not None:
        raise NotImplementedError(
            "the expert-parallel MoE (moe_apply_sharded) is TPU-mesh code "
            "with no counterpart on one card; pass mesh=None")
    return moe_apply_dense(p, x, cfg, router_bias, skip_empty=skip_empty,
                           use_kernel=use_kernel)
