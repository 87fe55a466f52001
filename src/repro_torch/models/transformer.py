"""Decoder-LM assembly: PyTorch port of `repro.models.transformer` for
every block type of the zoo: global attention (`"attn"`), MoE (`"moe"`),
RecurrentGemma's RG-LRU (`"rec"`) and local attention (`"lattn"`), and
RWKV6 (`"rwkv"`).

An architecture compiles to *segments*: a tuple of block types repeated N
times, with parameters stacked over the repeat axis.  The JAX package runs
a segment under `lax.scan`; here it is a Python loop over the layer index
that indexes views of the stacked tensors.

    dense/vlm/audio:  [(("attn",), L)]
    llama4 (moe/2):   [(("attn", "moe"), L/2)]
    arctic (moe+res): [(("moe",), L)]
    rwkv6:            [(("rwkv",), L)]
    recurrentgemma:   [(("rec","rec","lattn"), 12), (("rec","rec"), 1)]

Three execution modes share the block code:
    train   — full sequence, no cache;
    prefill — full sequence, emits per-layer cache (stacked over layers):
              K/V for "attn"/"moe", the last `window` K/V at their ring
              slots (or padded to `window`) for "lattn", the recurrent
              state for "rec" ({h, conv}) and "rwkv" ({s, shift_tm,
              shift_cm});
    decode  — one token, writes its K/V or the block's new state into the
              given cache in place and returns that cache.
Each MoE block's per-layer `expert_load` comes back in `aux`, stacked over
the segment's layers as (n, E) int32, in the JAX package's layout.

Training: `loss_fn` is the JAX package's next-token cross entropy (the
vocab loss chunked by `cfg.loss_chunk`, each chunk recomputed in the
backward).  `cfg.remat` checkpoints each layer of a segment in train
mode, the JAX scan body: "full" recomputes the layer in the backward,
"dots" keeps the outputs of the weight products (`aten.mm`) and
recomputes the rest (the counterpart of
`checkpoint_dots_with_no_batch_dims`: the batched attention products are
recomputed), "none" keeps everything.  A segment's stacked leaves are cut
into their layers by one `unbind` a leaf, so that a leaf's gradient is
stacked once rather than scattered into a zero tensor of the whole stack
for each layer.  On CUDA tensors the kernels' outputs take their plain
versions' gradients (`kernels.common.KernelVjp`).

`use_kernel` (None/"auto", "kernel", "plain"; carried in `Ctx`) reaches
the kernels, whose wrappers own the device choice: the flash kernel for
prefill (global, and windowed for "lattn": one call over the whole
prompt where the JAX model splits it into window-sized chunk pairs) and
the decode kernel for each decode step (over the window ring for
"lattn"), the grouped-FFN kernel `moe_gmm` at prefill and `moe_gmm_skip`
at a decode step, `rglru_scan` in every "rec" block and `rwkv6_scan` in
every "rwkv" block at every T, on CUDA tensors; their plain versions on
CPU tensors.

Sharding: `shd` is the reference's duck-typed context, here a
`repro_torch.sharding.ShardingPlan` over a `launch.mesh.Mesh` of the
job's ranks (anything else raises `TypeError`), or None: the one-device
model.  Under a plan every rank computes its blocks of what the
reference's GSPMD program computes, the collectives placed where the
specs imply them: every rank takes the whole batch and keeps its rows
(`plan.shard_inputs`), and its blocks of the weights
(`plan.shard_params`); each layer's FSDP blocks are all-gathered over
the data axes just before it runs (`plan.gather_data`) and dropped
after it, the top-level leaves (embed, final_norm, head) once a step
(`_top_blocks`: under the "dp" strategy they too are cut over every
axis); every tagged activation is relaid by `ctx.act` to the plan's
`act_spec` (`plan.act`).  So the embedding is a masked lookup into the
rank's vocab block summed over `model`; `wq`/`wi`/`wg` are
column-parallel, `wo` row-parallel with its sum reduce-scattered back
to the sequence-sharded residual stream (Megatron-SP) or all-reduced;
the `seq` strategy runs flash on the rank's query rows at their global
positions (`q_offset`, and the RoPE positions of its block) against the
all-gathered K/V; head-TP expands GQA K/V to one head a query head
first (`_expand_kv`), as the reference; the logits are vocab-sharded.
MoE blocks run `moe.moe_apply_sharded` on the rank's rows and experts
(under "dp" the rows gathered over `model` and the gathered experts cut
to the rank's, the reference's `shard_map` specs).
The recurrent blocks gather their rmsnormed input over the sequence
(their conv, token shift and scan run along time) and run on the rank's
block of the channels: RG-LRU's `rglru_scan` on its W/tp channels,
RWKV6's `rwkv6_scan` on its H/tp heads (the LoRA deltas, mixes and
decay computed over the whole width), each block's row-parallel output
summed back into the residual's layout; RWKV's channel mix sums
kk @ cv over d_ff before the replicated gate multiplies it.  Local
attention runs flash with the window on the rank's heads (or on its
block of the queries at their `q_offset` under `seq`).  A decode step
attends through `kvcache.decode_attention_sharded` over the rank's
block of each full-attention cache (batch over the data axes, sequence
over `model`) and through the window decode over its rows of a window
cache; `init_cache(..., shd=plan)` allocates only the rank's block of
every leaf by `plan.cache_specs` (the recurrent states' channels and
heads over `model`), and prefill returns each rank's blocks in that
decode layout.  Returned logits are the rank's block by
`act_spec("logits")`.  The train-mode forward runs the same per-rank
program under `cfg.remat` (a layer's FSDP gathers inside its checkpoint)
and `loss_fn` counts each token's term on one rank on the vocab-sharded
logits: the collectives are differentiable (`launch.mesh`), so one
backward a rank gives its terms of every gradient
(`sharding.partition`'s invariant).
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import flat_axes
from repro_torch.models import kvcache, layers, moe, rglru, rwkv6
from repro_torch.sharding.partition import (ShardingPlan, map_with_path,
                                           zip_map)
from repro_torch.tree_util import tree_map

__all__ = ["segments", "init_params", "init_cache", "Ctx", "apply_block",
           "run_segments", "forward", "loss_fn", "prefill", "decode_step",
           "DecoderLM"]

def check_plan(shd) -> ShardingPlan | None:
    """`shd` if it is None or a port `ShardingPlan`; raises otherwise."""
    if shd is not None and not isinstance(shd, ShardingPlan):
        raise TypeError(
            f"shd must be a repro_torch.sharding.ShardingPlan or None, not "
            f"{type(shd).__module__}.{type(shd).__name__}")
    return shd


# ---------------------------------------------------------------------------
# segment plan
# ---------------------------------------------------------------------------

def segments(cfg) -> list[tuple[tuple[str, ...], int]]:
    L = cfg.num_layers
    if cfg.ssm == "rwkv6":
        return [(("rwkv",), L)]
    if cfg.pattern:
        plen = len(cfg.pattern)
        body = tuple("lattn" if t == "attn" else t for t in cfg.pattern)
        segs = [(body, L // plen)]
        tail = L % plen
        if tail:
            segs.append((body[:tail], 1))
        return segs
    if cfg.is_moe:
        if cfg.moe_every == 1:
            return [(("moe",), L)]
        pat = tuple("attn" if i < cfg.moe_every - 1 else "moe"
                    for i in range(cfg.moe_every))
        return [(pat, L // cfg.moe_every)]
    return [(("attn",), L)]


# ---------------------------------------------------------------------------
# pytrees of tensors (nested dicts and lists)
# ---------------------------------------------------------------------------

def _tree_stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_tree_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


def _cat_layers(trees: list):
    """Per-layer trees whose leaves are (1, ...) slices, concatenated
    along dim 0 one leaf at a time, each layer's copy of a leaf dropped
    from `trees` as soon as the leaf is stacked."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _cat_layers([t.pop(k) for t in trees]) for k in list(first)}
    if isinstance(first, list):
        out = []
        for i in range(len(first)):
            out.append(_cat_layers([t[i] for t in trees]))
            for t in trees:
                t[i] = None
        return out
    out = torch.cat(trees)
    trees.clear()
    return out


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(btype: str, gen: torch.Generator, cfg, device):
    """One layer of a block; a moe block's router and experts are drawn
    by `init_params`, stacked."""
    d = cfg.d_model
    p = {"ln1": layers.init_rmsnorm(d, device),
         "ln2": layers.init_rmsnorm(d, device)}
    if btype in ("attn", "lattn", "moe"):
        p["attn"] = layers.init_attention(gen, cfg, device)
        if btype != "moe":
            p["mlp"] = layers.init_mlp(gen, cfg, device=device)
        elif cfg.dense_ff_residual:
            p["dense"] = layers.init_mlp(gen, cfg, cfg.dense_ff_residual,
                                         device)
    elif btype == "rwkv":
        p.update(rwkv6.init_rwkv_block(gen, cfg, device))
    elif btype == "rec":
        p["rec"] = rglru.init_rec_block(gen, cfg, device)
        p["mlp"] = layers.init_mlp(gen, cfg, device=device)
    else:
        raise ValueError(btype)
    return p


def init_params(cfg, generator: torch.Generator, device="cuda", keep=None):
    """Random parameters from `generator` (a `torch.Generator` on
    `device`): the JAX package's tree, leaf shapes, dtypes and scales.

    `keep(name, leaf)`, where given, is applied to every leaf as soon as
    it is drawn, and only what it returns is kept: a segment's leaves
    one layer at a time, each as the (1, ...) slice of its stacked leaf
    (`name` the stacked leaf's path), a MoE block's experts stacked.  So
    a rank can draw a model it cannot hold whole and keep its blocks
    (`plan.local_shard` of each), with one layer whole at a time.  The
    layers are stacked one leaf at a time; the draws are the same with
    or without `keep`."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    keep = keep or (lambda name, leaf: leaf)
    params: dict[str, Any] = {}
    if cfg.embed_inputs:
        params["embed"] = keep("embed", torch.randn(
            (cfg.vocab, cfg.d_model), generator=generator, dtype=dt,
            device=dev) * cfg.d_model ** -0.5)
    segs = []
    for si, (types, n) in enumerate(segments(cfg)):
        seg = _cat_layers([map_with_path(
            lambda name, leaf: keep(name, leaf[None]),
            [_init_block(t, generator, cfg, dev) for t in types],
            ("segments", si)) for _ in range(n)])
        for j, t in enumerate(types):
            if t == "moe":
                seg[j]["moe"] = map_with_path(
                    keep, moe.init_moe(generator, cfg, n, dev),
                    ("segments", si, j, "moe"))
        segs.append(seg)
    params["segments"] = segs
    params["final_norm"] = keep("final_norm",
                                layers.init_rmsnorm(cfg.d_model, dev))
    if not cfg.tie_embeddings:
        params["head"] = keep("head", torch.randn(
            (cfg.d_model, cfg.vocab), generator=generator, dtype=dt,
            device=dev) * cfg.d_model ** -0.5)
    return params


def _init_block_cache(btype, cfg, batch, length, device):
    if btype in ("attn", "moe"):
        return kvcache.init_full_cache(cfg, batch, length, device)
    if btype == "lattn":
        return kvcache.init_window_cache(cfg, batch, device)
    if btype == "rwkv":
        return rwkv6.init_rwkv_state(cfg, batch, device)
    if btype == "rec":
        return rglru.init_rec_state(cfg, batch, device)
    raise ValueError(btype)


def init_cache(cfg, batch: int, length: int, device="cuda", shd=None):
    """Decode cache for a max context of `length` tokens: per segment, per
    block type, its leaves stacked over the segment's n layers: {"k",
    "v"} of (n, batch, length, KH, Dh) for "attn"/"moe", of (n, batch,
    window, KH, Dh) for "lattn"; the f32 states {"h", "conv"} of "rec" and
    {"s", "shift_tm", "shift_cm"} of "rwkv".  Under a plan (`shd`) only
    this rank's block of each leaf by `cache_specs` is allocated."""
    plan = check_plan(shd)
    if plan is not None:
        dev = resolve_device(device)
        return map_with_path(
            lambda name, leaf: torch.zeros(
                plan.local_cache_shape(name, leaf), dtype=leaf.dtype,
                device=dev),
            init_cache(cfg, batch, length, "meta"))
    dev = resolve_device(device)
    out = []
    for types, n in segments(cfg):
        seg = []
        for t in types:
            one = _init_block_cache(t, cfg, batch, length, dev)
            seg.append({k: v.expand(n, *v.shape).contiguous()
                        for k, v in one.items()})
        out.append(seg)
    return out


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

class Ctx(NamedTuple):
    cfg: Any
    mode: str                    # train | prefill | decode
    positions: Any               # (B,T) ids, (B,T,3) mrope, or (B,) decode
    use_kernel: Any = None       # None/"auto" | "kernel" | "plain"
    router_bias: Any = None      # (E,) slot-hit routing bias (serving)
    shd: Any = None              # a ShardingPlan or None
    bt: tuple = ()               # under a plan: the global (B, T)

    @property
    def mesh(self):
        return getattr(self.shd, "mesh", None)

    @property
    def data_axes(self):
        return getattr(self.shd, "data_axes", ("data",))

    def act(self, x, kind, have=None, partial=None):
        """x relaid to the plan's layout of `kind` (`ShardingPlan.act`);
        x itself without a plan."""
        if self.shd is None:
            return x
        return self.shd.act(x, kind, have, partial)

    def spec(self, kind, *dims) -> tuple:
        """Under a plan, the spec of a `kind` activation of global shape
        (B, T, *dims)."""
        return self.shd.spec(kind, self.bt + dims)


def _prefill_cache(cfg, k, v, window):
    """Arrange prefill K/V as a decode-ready cache: the whole prompt for
    global attention; for local attention the last `window` tokens at
    their circular slots (abs_pos % window), or the prompt padded to
    `window`."""
    if not window:
        return {"k": k, "v": v}
    t, w = k.shape[1], cfg.window
    if t >= w:
        slots = torch.arange(t - w, t, device=k.device) % w
        order = torch.argsort(slots)
        return {"k": k[:, t - w:][:, order], "v": v[:, t - w:][:, order]}
    pad = (0, 0, 0, 0, 0, w - t)
    return {"k": torch.nn.functional.pad(k, pad),
            "v": torch.nn.functional.pad(v, pad)}


def _local_attention(q, k, v, window, use_kernel=None, q_offset=0):
    """Exact sliding-window attention: one causal, windowed call over the
    whole sequence.  The JAX model cuts a prompt longer than the window
    into window-sized chunks, each attending over itself and its
    predecessor (the two-chunk trick, which bounds a TPU kernel's work a
    chunk); that is the same function, and the flash kernel already skips
    key tiles older than the window.  The JAX model's precondition is
    kept on the whole prompt (k's T): T <= window or T a multiple of it.
    q may be a block of the prompt's queries at `q_offset`."""
    t = k.shape[1]
    if t > window and t % window:
        raise ValueError(
            f"local attention over {t} tokens needs T <= window ({window}) "
            f"or T a multiple of the window, as in the JAX model")
    return layers.flash_attention(q, k, v, causal=True, window=window,
                                  q_offset=q_offset, use_kernel=use_kernel)


def _expand_kv(k, g: int):
    """(B, T, KH, dh) -> (B, T, KH * g, dh): each kv head repeated for its
    g query heads."""
    b, t, kh, dh = k.shape
    return k[:, :, :, None, :].expand(b, t, kh, g, dh).reshape(
        b, t, kh * g, dh)


def _local_qkv(p, ps, ctx):
    """The attention weights a rank computes with: under a plan each bias
    cut to its weight's block of columns."""
    if ctx.shd is None:
        return p
    return {k: ctx.shd.relayout(w, ps[k], ps["w" + k[1]][1:])
            if k.startswith("b") else w for k, w in p.items()}


def _attention(p, x, cache, ctx, window: int, ps=None):
    """One attention sub-block on this rank's blocks: x (and the output)
    laid out as "hidden"; `ps` the compute specs of `p` under a plan."""
    cfg, plan = ctx.cfg, ctx.shd
    b, t, _ = x.shape
    hid = ain = None
    if plan is not None:
        hid = ctx.spec("hidden", cfg.d_model)
        ain = ctx.spec("attn_in", cfg.d_model)
    h = layers.rmsnorm(x, p["ln1"])
    h = ctx.act(h, "attn_in", hid)
    pos = ctx.positions
    if ctx.mode == "decode":
        rope_pos = pos[:, None] if cfg.pos == "rope" else \
            pos[:, None, None].expand(b, 1, 3)
    elif plan is not None:
        # the global positions of this rank's rows and sequence block
        rope_pos = plan.relayout(pos, (ain[0],), ain[:2])
    else:
        rope_pos = pos
    q, k, v = layers.qkv(_local_qkv(p["attn"], ps and ps["attn"], ctx), h,
                         cfg, rope_pos)
    qs = ks = None
    if plan is not None:
        # a column block of wq is a block of the heads
        qs = ain[:2] + (ps["attn"]["wq"][1], None)
        ks = ain[:2] + (ps["attn"]["wk"][1], None)
    q = ctx.act(q, "q_heads", qs)
    if plan is not None:
        qh = ctx.spec("q_heads", cfg.num_heads, cfg.head_dim)
    if ctx.mode == "decode":
        if window:
            o, new_cache = kvcache.window_decode_attention(
                q, cache, k, v, pos, cfg, use_kernel=ctx.use_kernel)
        else:
            o, new_cache = kvcache.decode_attention(
                q, cache, k, v, pos, cfg, ctx.mesh, use_kernel=ctx.use_kernel,
                data_axes=ctx.data_axes)
    else:
        kc, vc = k, v
        k = ctx.act(k, "kv_heads", ks)
        v = ctx.act(v, "kv_heads", ks)
        kq, vq = k, v
        q_offset = 0
        if plan is not None:
            kvh = ctx.spec("kv_heads", cfg.num_kv_heads, cfg.head_dim)
            if plan.strategy == "heads" and cfg.q_per_kv > 1:
                # GQA under head-TP: one kv head a query head before the
                # kernel, as the reference (whose sharded reshape needs it)
                kq = ctx.act(_expand_kv(k, cfg.q_per_kv), "q_heads", kvh)
                vq = ctx.act(_expand_kv(v, cfg.q_per_kv), "q_heads", kvh)
            else:   # this rank's query heads' kv heads
                kq = plan.relayout(k, kvh, kvh[:2] + qh[2:])
                vq = plan.relayout(v, kvh, kvh[:2] + qh[2:])
            # a sequence block of q sits at its global positions
            q_offset = plan.block(ctx.bt[1], qh[1]).start or 0
        if window:
            o = _local_attention(q, kq, vq, window, ctx.use_kernel, q_offset)
        else:
            o = layers.flash_attention(q, kq, vq, causal=True,
                                       q_offset=q_offset,
                                       use_kernel=ctx.use_kernel)
        new_cache = None
        if ctx.mode == "prefill":
            if plan is not None:
                # the decode layout: a full cache's sequence over model; a
                # window cache (rows only) made from the whole prompt
                length = cfg.window if window else ctx.bt[1]
                cs = plan.cache_spec("0/0/k", (1, ctx.bt[0], length) + tuple(
                    kc.shape[2:]))[1:]
                kc = plan.relayout(kc, ks, cs)
                vc = plan.relayout(vc, ks, cs)
            new_cache = _prefill_cache(cfg, kc, vc, window)
    o = o.reshape(b, o.shape[1], -1)
    if plan is None:
        return o @ p["attn"]["wo"], new_cache
    aos = ctx.spec("attn_out", cfg.num_heads * cfg.head_dim)
    o = ctx.act(o, "attn_out", qh[:3])
    # row-parallel wo: this rank's rows of o, then a sum over them
    rows = ps["attn"]["wo"][0]
    o = plan.relayout(o, aos, aos[:2] + (rows,))
    return ctx.act(_row_parallel(ctx, rows)(o, p["attn"]["wo"]), "hidden",
                   aos[:2] + (None,), partial=rows).to(x.dtype), new_cache


def _row_parallel(ctx, rows):
    """The product `a @ w` of a block of w whose rows split over `rows`
    (the compute spec's entry): where that leaves a sum over more than
    one rank pending, this rank's term in f32, so that the sum is rounded
    to the activations' dtype once, after it, as the one-rank product's
    f32 accumulator is; else the plain product."""
    if ctx.shd is None or rows is None or ctx.shd._size(rows) == 1:
        return torch.matmul
    return lambda a, w: a @ w if a.dtype == torch.float32 \
        else a.float() @ w.float()


def _carry_state(cache, new, ctx):
    """A recurrent block's new state: written into the given cache in
    place at a decode step (which returns that cache), returned as is
    otherwise."""
    if ctx.mode != "decode":
        return new
    for name, value in new.items():
        cache[name].copy_(value)
    return cache


def _mlp_sum(p, h, ctx, ps=None, name="mlp"):
    """An MLP on `h` (laid out as "mlp_in") into the "hidden" layout:
    under a plan wi/wg are column-parallel and wo row-parallel, the
    sum over wo's rows taken by `ctx.act`."""
    if ctx.shd is None:
        return layers.apply_mlp(p[name], h, ctx.cfg)
    rows = ps[name]["wo"][0]
    out = layers.apply_mlp(p[name], h, ctx.cfg, _row_parallel(ctx, rows))
    return ctx.act(out, "hidden", ctx.spec("mlp_in", ctx.cfg.d_model),
                   partial=rows).to(h.dtype)


def _rows(x, ctx):
    """A "hidden" block (B_loc, T_loc, D) with its sequence put back
    together: this rank's rows, T and D whole."""
    hid = ctx.spec("hidden", ctx.cfg.d_model)
    return ctx.shd.relayout(x, hid, hid[:1])


def _rec_sharded(p, x, cache, ctx, ps):
    """An RG-LRU block on this rank's block of the W channels: the
    rmsnormed input gathered over the sequence (the conv and the scan run
    along time), the rank's columns of wx/wgate/conv, gates and state,
    and its rows of wout, whose sum over the channels is relaid into the
    residual's layout; then the block's MLP as the attention blocks'."""
    cfg = ctx.cfg
    hid = ctx.spec("hidden", cfg.d_model)
    h = _rows(layers.rmsnorm(x, p["ln1"]), ctx)
    rows = ps["rec"]["wout"][0]
    o, new = rglru.rec_block(p["rec"], h, cache, cfg, ctx.use_kernel,
                             _row_parallel(ctx, rows))
    x = x + ctx.act(o, "hidden", hid[:1], partial=rows).to(x.dtype)
    h2 = ctx.act(layers.rmsnorm(x, p["ln2"]), "mlp_in", hid)
    return x + _mlp_sum(p, h2, ctx, ps), new


def _rwkv_sharded(p, x, cache, ctx, ps):
    """An RWKV6 block on this rank's block of the heads and of d_ff.  Time
    mix: the rmsnormed input gathered over the sequence (the token shift
    and the scan run along time), the LoRA deltas, the mixes and the
    decay over the whole width, the rank's columns of wr/wk/wv/wg and of
    the decay, its heads of u, ln_o, ln_o_b and the state, its rows of
    wo; the sum over the heads relaid into the residual's layout.
    Channel mix: kk @ cv summed over d_ff first, then multiplied by the
    gate sigmoid(xr @ cr), computed (cr whole) for the residual's rows
    alone.  The token shifts hold the whole width of the rank's rows."""
    cfg, plan = ctx.cfg, ctx.shd
    hid = ctx.spec("hidden", cfg.d_model)
    b = x.shape[0]
    cols = ps["wr"][1]
    if cols != ps["u"][0]:
        raise ValueError(
            f"{cfg.name}: wr's columns split over {cols!r} but its heads "
            f"over {ps['u'][0]!r}: the heads must split with the columns")
    if cache is None:
        shift_tm = shift_cm = x.new_zeros((b, cfg.d_model))
        s0 = None
    else:
        shift_tm, shift_cm = (cache[k].to(x.dtype)
                              for k in ("shift_tm", "shift_cm"))
        s0 = cache["s"].contiguous()
    h = _rows(layers.rmsnorm(x, p["ln1"]), ctx)
    o, x_last_tm, s_new = rwkv6.time_mix(
        p, h, shift_tm, s0, cfg, ctx.use_kernel,
        plan.block(cfg.d_model, cols), _row_parallel(ctx, ps["wo"][0]))
    x = x + ctx.act(o, "hidden", hid[:1], partial=ps["wo"][0]).to(x.dtype)
    h2 = _rows(layers.rmsnorm(x, p["ln2"]), ctx)
    kv, xr = rwkv6.channel_mix_terms(p, h2, shift_cm,
                                     _row_parallel(ctx, ps["cv"][0]))
    kv = ctx.act(kv, "hidden", hid[:1], partial=ps["cv"][0]).to(x.dtype)
    xr = plan.relayout(xr, hid[:1], hid)
    x = x + torch.sigmoid(xr @ p["cr"]) * kv
    return x, {"s": s_new, "shift_tm": x_last_tm.float(),
               "shift_cm": h2[:, -1, :].float()}


def _moe_blocks(p, h, ctx, mi):
    """(the expert weights, the input, its spec) as the expert-parallel
    MoE takes them under a plan: the rank's experts and its rows over the
    data axes.  The other strategies lay them out so already (h by
    `mi`); under "dp" the weights come gathered whole and the rows split
    over every axis, so each rank keeps its experts of `model` and
    gathers its rows over it (the reference's `shard_map` specs)."""
    plan = ctx.shd
    if plan.strategy != "dp":
        return p, h, mi
    m = plan.model_axis
    experts = plan.block(ctx.cfg.num_experts, m)
    p = {k: w if k == "router" else w[experts] for k, w in p.items()}
    xs = plan._fit_cache((plan.dp, None, None), ctx.bt + (ctx.cfg.d_model,))
    return p, plan.relayout(h, mi, xs), xs


def apply_block(btype, p, x, cache, ctx, ps=None):
    """One block on this rank's blocks; `ps` (under a plan) the compute
    specs of the block's weights `p` (`plan.compute_spec`)."""
    cfg = ctx.cfg
    aux = {}
    if btype in ("attn", "lattn", "moe"):
        window = cfg.window if btype == "lattn" else 0
        o, new_cache = _attention(p, x, cache, ctx, window, ps)
        x = x + o
        h = layers.rmsnorm(x, p["ln2"])
        hid = None if ctx.shd is None else ctx.spec("hidden", cfg.d_model)
        h = ctx.act(h, "mlp_in", hid)
        if btype != "moe":
            return x + _mlp_sum(p, h, ctx, ps), new_cache, aux
        pm, hm = p["moe"], h
        if ctx.shd is not None:
            mi = ctx.spec("mlp_in", cfg.d_model)
            pm, hm, xs = _moe_blocks(pm, h, ctx, mi)
            if xs[0] is None and ctx.shd._size(ctx.shd.dp) > 1:
                raise ValueError(
                    f"an MoE block under a plan needs its batch of "
                    f"{ctx.bt[0]} divisible by the data axes "
                    f"{ctx.shd.data_axes}")
        mo, aux = moe.moe_apply(pm, hm, cfg, ctx.mesh,
                                router_bias=ctx.router_bias,
                                skip_empty=ctx.mode == "decode",
                                use_kernel=ctx.use_kernel,
                                data_axes=ctx.data_axes)
        if ctx.shd is not None:   # summed over model inside
            mo = ctx.act(ctx.shd.relayout(mo, xs, mi), "hidden", mi)
        if cfg.dense_ff_residual:
            mo = mo + _mlp_sum(p, h, ctx, ps, "dense")
        return x + mo, new_cache, aux
    if btype in ("rwkv", "rec") and ctx.shd is not None:
        block = _rwkv_sharded if btype == "rwkv" else _rec_sharded
        x, new = block(p, x, cache, ctx, ps)
        return x, _carry_state(cache, new, ctx), aux
    if btype == "rwkv":
        st = cache if cache is not None else rwkv6.init_rwkv_state(
            cfg, x.shape[0], x.device)
        h = layers.rmsnorm(x, p["ln1"])
        o, x_last_tm, s_new = rwkv6.time_mix(
            p, h, st["shift_tm"].to(x.dtype), st["s"], cfg, ctx.use_kernel)
        x = x + o
        h2 = layers.rmsnorm(x, p["ln2"])
        o2, x_last_cm = rwkv6.channel_mix(p, h2,
                                          st["shift_cm"].to(x.dtype))
        x = x + o2
        new = {"s": s_new, "shift_tm": x_last_tm.float(),
               "shift_cm": x_last_cm.float()}
        return x, _carry_state(cache, new, ctx), aux
    if btype == "rec":
        st = cache if cache is not None else rglru.init_rec_state(
            cfg, x.shape[0], x.device)
        h = layers.rmsnorm(x, p["ln1"])
        o, new = rglru.rec_block(p["rec"], h, st, cfg, ctx.use_kernel)
        x = x + o
        h2 = layers.rmsnorm(x, p["ln2"])
        x = x + layers.apply_mlp(p["mlp"], h2, cfg)
        return x, _carry_state(cache, new, ctx), aux
    raise ValueError(btype)


# ---------------------------------------------------------------------------
# segment loop
# ---------------------------------------------------------------------------

def _layer(tree, i: int):
    """Layer i's view of a tree stacked over layers."""
    return tree_map(lambda a: a[i], tree)


def _unstack(tree, n: int) -> list:
    """The n layers' views of a tree stacked over layers, by one `unbind`
    a leaf."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        per = [_unstack(v, n) for v in tree]
        return [[p[i] for p in per] for i in range(n)]
    return list(tree.unbind(0))


def _save_dots(ctx, op, *args, **kwargs):
    """remat="dots": keep the weight products, recompute the rest."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg) -> dict | None:
    """`checkpoint`'s keyword arguments for `cfg.remat`, or None for no
    checkpoint."""
    if cfg.remat == "none":
        return None
    if cfg.remat == "full":
        return {}
    if cfg.remat == "dots":
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}
    raise ValueError(f"remat {cfg.remat!r}: expected full, dots or none")


def _layer_blocks(types, p_list, x, caches, ctx, specs=None, comp=None):
    """One layer of a segment (the JAX package's scan body): x, each
    block's new cache and aux.  Under a plan each block's FSDP blocks are
    gathered over the data axes just before it runs (`specs` the layer's
    specs, `comp` their compute specs) and dropped after it; under
    remat's checkpoint the backward's recompute gathers them again."""
    ncs, auxes = [], []
    for j, bt in enumerate(types):
        p, ps = p_list[j], None
        if specs is not None:
            p = zip_map(ctx.shd.gather_data, p, specs[j])
            ps = comp[j]
        x, nc, aux = apply_block(bt, p, x, caches[j], ctx, ps)
        del p
        ncs.append(nc)
        auxes.append(aux)
    return x, ncs, auxes


def run_segments(params, x, caches, ctx):
    """caches: None (train/prefill) or list matching segments (decode,
    written in place).  Returns (x, caches, aux): prefill's caches are
    stacked over layers, decode's are the caches given; aux holds, per
    segment and block, `{"expert_load": (n, E) int32}` for a moe block
    and `{}` for the others.  In train mode each layer runs under
    `cfg.remat`'s checkpoint."""
    cfg, plan = ctx.cfg, ctx.shd
    remat = _remat(cfg) if ctx.mode == "train" else None
    all_caches, all_aux = [], []
    for si, (types, n) in enumerate(segments(cfg)):
        seg_params = _unstack(params["segments"][si], n)
        seg_cache = caches[si] if caches is not None else None
        seg_specs = comp = None
        if plan is not None:   # a layer's specs: the stacked dim dropped
            seg_specs = map_with_path(lambda _, spec: spec[1:],
                                      plan.model_specs()["segments"][si])
            comp = map_with_path(lambda _, spec: plan.compute_spec(spec),
                                 seg_specs)
        per_layer, per_aux = [], []
        for i in range(n):
            cs = [None if seg_cache is None else _layer(seg_cache[j], i)
                  for j in range(len(types))]
            args = (types, seg_params[i], x, cs, ctx, seg_specs, comp)
            if remat is not None:
                x, ncs, auxes = checkpoint(_layer_blocks, *args,
                                           use_reentrant=False, **remat)
            else:
                x, ncs, auxes = _layer_blocks(*args)
            per_layer.append(ncs)
            per_aux.append(auxes)
        if ctx.mode == "prefill":
            all_caches.append(_tree_stack(per_layer))
        elif ctx.mode == "decode":
            all_caches.append(seg_cache)
        else:
            all_caches.append([None] * len(types))
        all_aux.append(_tree_stack(per_aux))
    return x, all_caches, all_aux


# ---------------------------------------------------------------------------
# top level: forward / prefill / decode
# ---------------------------------------------------------------------------

def _on_device(params, batch) -> dict:
    dev = params["final_norm"].device
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


_TOP = ("embed", "final_norm", "head")


def _top_blocks(params, plan):
    """`params` with the top-level leaves (embed, final_norm, head) as the
    rank computes with them: under a plan each gathered over the data
    axes that cut its storage (`plan.gather_data`, once a step: the
    "dp" strategy cuts every leaf over every axis), laid out by its
    `compute_spec`; `params` itself without a plan."""
    if plan is None:
        return params
    specs = plan.model_specs()
    return {k: plan.gather_data(v, specs[k]) if k in _TOP else v
            for k, v in params.items()}


def _embed_in(cfg, params, batch, ctx):
    """The embedded inputs, laid out as "hidden".  Under a plan the
    embedding is the rank's block of the vocabulary by its compute spec
    (`params` from `_top_blocks`): a masked lookup, summed over the axes
    that split it."""
    if not cfg.embed_inputs:
        x, part = batch["embeds"].to(cfg.torch_dtype), None
    elif ctx.shd is None:
        return params["embed"][batch["tokens"].long()]
    else:
        emb = params["embed"]
        part = ctx.shd.compute_spec(ctx.shd.model_specs()["embed"])[0]
        ids = batch["tokens"].long()
        if part is not None:
            ids = ids - ctx.shd.block(emb.shape[0] * ctx.shd._size(part),
                                      part).start
        ok = (ids >= 0) & (ids < emb.shape[0])
        x = torch.where(ok[..., None], emb[ids.clamp(0, emb.shape[0] - 1)],
                        0)
    if ctx.shd is None:
        return x
    rows = ctx.spec("hidden", cfg.d_model)[:1]
    return ctx.act(x, "hidden", rows, partial=part)


def _positions_for(cfg, batch, t):
    if cfg.pos == "mrope":
        return batch["positions"]
    x = batch["tokens"] if "tokens" in batch else batch["embeds"]
    return torch.arange(t, device=x.device)[None, :].expand(x.shape[0], t)


def _logits(cfg, params, x, ctx):
    """Logits of x (B, T, D; under a plan this rank's rows, T and D
    whole), under a plan this rank's block by `act_spec("logits")`
    (`params` from `_top_blocks`)."""
    plan = ctx.shd
    head = params.get("head")
    if plan is None:
        return x @ (params["embed"].T if head is None else head)
    specs = plan.model_specs()
    if head is None:
        w, cols = params["embed"].T, plan.compute_spec(specs["embed"])[0]
    else:
        w, cols = head, plan.compute_spec(specs["head"])[1]
    rows = ctx.spec("hidden", cfg.d_model)[:1]
    return ctx.act(x @ w, "logits", rows + (None, cols))


def _shard_batch(cfg, batch, plan) -> tuple[dict, tuple]:
    """(this rank's rows of every input of `batch` but the router bias,
    the global (B, T)) under a plan; (batch, ()) without one."""
    if plan is None:
        return batch, ()
    x = batch["tokens"] if "tokens" in batch else batch["embeds"]
    rows = {k: v for k, v in batch.items() if k != "router_bias"}
    return {**batch, **plan.shard_inputs(rows)}, tuple(x.shape[:2])


def _forward(cfg, params, batch, plan, mode, use_kernel):
    """`forward`'s result and the top-level leaves it computed with
    (`_top_blocks`), for the logits that follow it."""
    batch, bt = _shard_batch(cfg, _on_device(params, batch), plan)
    t = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[1]
    ctx = Ctx(cfg=cfg, mode=mode, positions=_positions_for(cfg, batch, t),
              use_kernel=use_kernel, shd=plan, bt=bt)
    params = _top_blocks(params, plan)
    x = _embed_in(cfg, params, batch, ctx)
    x, caches, aux = run_segments(params, x, None, ctx)
    x = layers.rmsnorm(x, params["final_norm"])
    return x, caches, aux, ctx, params


def forward(cfg, params, batch, shd=None, mode="train", use_kernel=None):
    """Full-sequence pass.  Returns (final-normed hidden (B,T,D), caches,
    aux, ctx); under a plan (`shd`, a whole batch on every rank) this
    rank's blocks."""
    return _forward(cfg, params, batch, check_plan(shd), mode,
                    use_kernel)[:4]


def _xent(cfg, params, ctx, xc, tc, wc):
    """The weighted sum of a chunk's token terms, logsumexp(logits) less
    the gold logit.  Under a plan xc is this rank's rows (T and D whole)
    and the logits its block by `act_spec("logits")`: where that splits
    the vocabulary, the row max is a detached all_reduce (max), the sum
    of exponentials an all_reduce (sum), and the gold logit a masked pick
    on the rank that holds it, summed likewise."""
    logits = _logits(cfg, params, xc, ctx).float()
    cols = None if ctx.shd is None else ctx.spec("logits", cfg.vocab)[2]
    if cols is None or ctx.shd._size(cols) == 1:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tc[..., None])[..., 0]
        return ((logz - gold) * wc).sum()
    mesh, v = ctx.mesh, logits.shape[-1]
    mx = mesh.all_reduce(logits.detach().amax(dim=-1), cols, "max")
    logz = mx + torch.log(mesh.all_reduce(
        torch.exp(logits - mx[..., None]).sum(dim=-1), cols))
    ids = tc - ctx.shd.block(cfg.vocab, cols).start
    ok = (ids >= 0) & (ids < v)
    gold = torch.gather(logits, -1, ids.clamp(0, v - 1)[..., None])[..., 0]
    gold = mesh.all_reduce(torch.where(ok, gold, 0.0), cols)
    return ((logz - gold) * wc).sum()


def _loss_blocks(x, targets, weights, ctx):
    """Under a plan: (x, this rank's "hidden" block, with its sequence
    gathered: its rows, T and D whole; its rows of the targets; its rows
    of the weights times 0/1, so that each token's term counts on one
    rank alone: on the rank whose block of the sequence (by "hidden")
    holds it, and of the other axes that share the term, on index 0)."""
    plan = ctx.shd
    hid = ctx.spec("hidden", ctx.cfg.d_model)
    x = _rows(x, ctx)
    targets = plan.relayout(targets, (), hid[:1])
    weights = plan.relayout(weights, (), hid[:1])
    split = set(flat_axes(hid[0])) | set(flat_axes(hid[1]))
    rest = [a for a in plan.replicated_axes(()) if a not in split]
    own = torch.zeros_like(weights[0])
    own[plan.block(own.shape[0], hid[1])] = float(
        all(plan.mesh.axis_index(a) == 0 for a in rest))
    return x, targets, weights * own


def loss_fn(cfg, params, batch, shd=None, use_kernel=None):
    """Next-token cross entropy (mean over the B*(T-1) predicted tokens);
    returns (loss, aux).  The targets are the inputs shifted by padding
    (T stays divisible by the chunk), the last position weighted 0.  When
    `cfg.loss_chunk` divides T (the global T under a plan), the vocab
    loss runs chunk by chunk, each under `checkpoint`, so that no (B, T,
    V) f32 logits are kept for the backward.  A MoE layer's `lb_loss` in
    aux would add 0.01 times its mean, as in the JAX package; neither
    package's MoE returns one (aux holds `expert_load` only).

    Under a plan (`shd`; the whole batch on every rank, its blocks of the
    weights) each rank sums the terms of its tokens (`_loss_blocks`: its
    rows, and of the sequence the block it holds in the residual stream)
    on the vocab-sharded logits (`_xent`), so the ranks' local losses sum
    to the global one; the loss returned has the global mean as its
    value on every rank (a detached all_reduce over every axis) and this
    rank's term's gradient."""
    plan = check_plan(shd)
    x, _, aux, ctx, top = _forward(cfg, params, batch, plan, "train",
                                   use_kernel)
    batch = _on_device(params, batch)
    tgt = batch["tokens"] if cfg.embed_inputs else batch["labels"]
    targets = F.pad(tgt[:, 1:].long(), (0, 1))
    weights = torch.ones(targets.shape, dtype=torch.float32,
                         device=x.device)
    weights[:, -1] = 0.0
    b, t = targets.shape
    if plan is not None:
        x, targets, weights = _loss_blocks(x, targets, weights, ctx)
    xent = functools.partial(_xent, cfg, top, ctx)
    chunk = cfg.loss_chunk
    if chunk and t % chunk == 0:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, t, chunk):
            part = slice(c0, c0 + chunk)
            total = total + checkpoint(xent, x[:, part], targets[:, part],
                                       weights[:, part], use_reentrant=False)
    else:
        total = xent(x, targets, weights)
    loss = total / (b * (t - 1))
    if plan is not None:
        whole = plan.mesh.all_reduce(loss.detach(), plan.mesh.axis_names)
        loss = loss + (whole - loss).detach()
    lb = [a.get("lb_loss") for seg in aux for a in seg
          if isinstance(a, dict) and a.get("lb_loss") is not None]
    if lb:
        loss = loss + 0.01 * sum(torch.mean(v) for v in lb)
    return loss, aux


def prefill(cfg, params, batch, shd=None, use_kernel=None):
    """Returns (last-token logits (B,1,V), decode-ready cache, aux).
    Under a plan (`shd`; every rank given the whole batch and its blocks
    of the weights, `plan.shard_params`) this rank's blocks: of the
    logits by `act_spec("logits")`, of the cache by `cache_specs` (the
    decode layout)."""
    x, caches, aux, ctx, top = _forward(cfg, params, batch,
                                        check_plan(shd), "prefill",
                                        use_kernel)
    last = x[:, -1:]
    if ctx.shd is not None:   # the last position's block holds it
        hid = ctx.spec("hidden", cfg.d_model)
        last = ctx.shd.relayout(last, hid, hid[:1])[:, -1:]
    return _logits(cfg, top, last, ctx), caches, aux


def decode_step(cfg, params, batch, cache, shd=None, use_kernel=None):
    """One token for every sequence.  batch: tokens/embeds (B,1,...) +
    positions (B,) [+ router_bias (E,) for MoE archs].  Writes the token's
    K/V into `cache` in place and returns (logits (B,1,V), that cache,
    aux).  Under a plan (`shd`) every rank takes the whole batch, its
    blocks of the weights and of `cache` (`init_cache(..., shd=plan)`),
    and returns its block of the logits."""
    plan = check_plan(shd)
    batch, bt = _shard_batch(cfg, _on_device(params, batch), plan)
    ctx = Ctx(cfg=cfg, mode="decode",
              positions=batch["positions"].to(torch.int32),
              use_kernel=use_kernel, router_bias=batch.get("router_bias"),
              shd=plan, bt=bt)
    params = _top_blocks(params, plan)
    x = _embed_in(cfg, params, batch, ctx)
    x, caches, aux = run_segments(params, x, cache, ctx)
    x = layers.rmsnorm(x, params["final_norm"])
    return _logits(cfg, params, x, ctx), caches, aux


# ---------------------------------------------------------------------------
# the same model as an nn.Module
# ---------------------------------------------------------------------------

class _Tree(nn.Module):
    """A nested dict/list of tensors held as trainable parameters, with
    sub-dicts and lists as submodules named by key or index.  `tree()`
    gives the parameters themselves back, so a loss taken through the
    functional entry points reaches them; the serving paths run under
    `torch.no_grad()`."""

    def __init__(self, tree):
        super().__init__()
        self._kind = "list" if isinstance(tree, list) else "dict"
        items = enumerate(tree) if isinstance(tree, list) else tree.items()
        self._keys = []
        for k, v in items:
            name = str(k)
            self._keys.append(k)
            if isinstance(v, torch.Tensor):
                self.register_parameter(name, nn.Parameter(v))
            else:
                self.add_module(name, _Tree(v))

    def tree(self):
        vals = []
        for k in self._keys:
            v = getattr(self, str(k))
            vals.append(v.tree() if isinstance(v, _Tree) else v)
        if self._kind == "list":
            return vals
        return dict(zip(self._keys, vals))


class DecoderLM(nn.Module):
    """The decoder as an `nn.Module`: `params` (the functional tree, e.g.
    from `init_params` or `params_from_numpy`) held as parameters with
    their JAX nesting as names (`segments.0.0.attn.wq`, ...), trainable.
    `params()` gives the tree of parameters back for the functional entry
    points (`loss_fn` among them); `prefill` and `decode_step` serve on
    the parameters detached, under `torch.no_grad()` (a tensor that
    requires grad can steer an op to another kernel even without grad
    mode, so the detached tensors give what the functional entry points
    give on the tree the module was built from)."""

    def __init__(self, cfg, params):
        super().__init__()
        self.cfg = cfg
        self.tree = _Tree(params)

    def params(self):
        return self.tree.tree()

    def forward(self, batch, use_kernel=None):
        """Logits (B, T, V) of a full sequence."""
        x, _, _, ctx = forward(self.cfg, self.params(), batch,
                               use_kernel=use_kernel)
        return _logits(self.cfg, self.params(), x, ctx)

    def _detached(self):
        return tree_map(lambda p: p.detach(), self.params())

    @torch.no_grad()
    def prefill(self, batch, use_kernel=None):
        return prefill(self.cfg, self._detached(), batch,
                       use_kernel=use_kernel)

    @torch.no_grad()
    def decode_step(self, batch, cache, use_kernel=None):
        return decode_step(self.cfg, self._detached(), batch, cache,
                           use_kernel=use_kernel)
