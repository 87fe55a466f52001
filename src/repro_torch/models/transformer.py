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
model.  Under a plan every rank runs the model on replicated activations
and the plan's blocks of what the reference's `shard_map` sections take
sharded: each MoE block runs `moe.moe_apply_sharded` on its rows of the
batch and its experts (`plan.shard_params` cuts them), and a decode step
attends through `kvcache.decode_attention_sharded` over its block of
each full-attention cache (`init_cache(..., shd=plan)` allocates only
that block; batch over the data axes, sequence over `model`), the
rows all-gathered back over the data axes.  Prefill returns the whole
prompt's cache on every rank (`plan.shard_cache` cuts a rank's block).
Head-TP prefill expands GQA K/V to one head a query head first
(`_expand_kv`), as the reference.  Dense weights stay whole, `ctx.act`
returns its activation; training under a plan is not ported (`loss_fn`
raises).
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
from repro_torch.models import kvcache, layers, moe, rglru, rwkv6
from repro_torch.sharding.partition import ShardingPlan, map_with_path
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


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random parameters from `generator` (a `torch.Generator` on
    `device`): the JAX package's tree, leaf shapes, dtypes and scales."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    params: dict[str, Any] = {}
    if cfg.embed_inputs:
        params["embed"] = torch.randn(
            (cfg.vocab, cfg.d_model), generator=generator, dtype=dt,
            device=dev) * cfg.d_model ** -0.5
    segs = []
    for types, n in segments(cfg):
        seg = _tree_stack([[_init_block(t, generator, cfg, dev)
                            for t in types] for _ in range(n)])
        for j, t in enumerate(types):
            if t == "moe":
                seg[j]["moe"] = moe.init_moe(generator, cfg, n, dev)
        segs.append(seg)
    params["segments"] = segs
    params["final_norm"] = layers.init_rmsnorm(cfg.d_model, dev)
    if not cfg.tie_embeddings:
        params["head"] = torch.randn(
            (cfg.d_model, cfg.vocab), generator=generator, dtype=dt,
            device=dev) * cfg.d_model ** -0.5
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
    this rank's block of each "attn"/"moe" K/V leaf is allocated."""
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

    @property
    def mesh(self):
        return getattr(self.shd, "mesh", None)

    @property
    def data_axes(self):
        return getattr(self.shd, "data_axes", ("data",))

    def act(self, x, kind):
        return self.shd.act(x, kind) if self.shd is not None else x

    def rows(self, x):
        """This rank's rows of a replicated batch (all of them without a
        plan)."""
        if self.shd is None:
            return x
        return x[self.shd.block(x.shape[0], self.shd.dp)]

    def gather_rows(self, x):
        """The ranks' rows all-gathered back over the data axes."""
        if self.shd is None:
            return x
        return self.mesh.all_gather(x, self.data_axes, dim=0)


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


def _local_attention(q, k, v, window, use_kernel=None):
    """Exact sliding-window attention: one causal, windowed call over the
    whole sequence.  The JAX model cuts a prompt longer than the window
    into window-sized chunks, each attending over itself and its
    predecessor (the two-chunk trick, which bounds a TPU kernel's work a
    chunk); that is the same function, and the flash kernel already skips
    key tiles older than the window.  The JAX model's precondition is
    kept: T <= window or T a multiple of it."""
    t = q.shape[1]
    if t > window and t % window:
        raise ValueError(
            f"local attention over {t} tokens needs T <= window ({window}) "
            f"or T a multiple of the window, as in the JAX model")
    return layers.flash_attention(q, k, v, causal=True, window=window,
                                  use_kernel=use_kernel)


def _expand_kv(k, g: int):
    """(B, T, KH, dh) -> (B, T, KH * g, dh): each kv head repeated for its
    g query heads."""
    b, t, kh, dh = k.shape
    return k[:, :, :, None, :].expand(b, t, kh, g, dh).reshape(
        b, t, kh * g, dh)


def _attention(p, x, cache, ctx, window: int):
    cfg = ctx.cfg
    b, t, _ = x.shape
    h = layers.rmsnorm(x, p["ln1"])
    h = ctx.act(h, "attn_in")
    pos = ctx.positions
    if ctx.mode == "decode":
        rope_pos = pos[:, None] if cfg.pos == "rope" else \
            pos[:, None, None].expand(b, 1, 3)
    else:
        rope_pos = pos
    q, k, v = layers.qkv(p["attn"], h, cfg, rope_pos)
    q = ctx.act(q, "q_heads")
    if ctx.mode == "decode":
        if window:
            o, new_cache = kvcache.window_decode_attention(
                q, cache, k, v, pos, cfg, use_kernel=ctx.use_kernel)
        elif ctx.mesh is not None:
            o, new_cache = kvcache.decode_attention(
                ctx.rows(q), cache, ctx.rows(k), ctx.rows(v), ctx.rows(pos),
                cfg, ctx.mesh, data_axes=ctx.data_axes)
            o = ctx.gather_rows(o)
        else:
            o, new_cache = kvcache.decode_attention(
                q, cache, k, v, pos, cfg, use_kernel=ctx.use_kernel)
    else:
        k = ctx.act(k, "kv_heads")
        v = ctx.act(v, "kv_heads")
        kq, vq = k, v
        if (ctx.shd is not None and ctx.shd.strategy == "heads"
                and cfg.q_per_kv > 1):
            # GQA under head-TP: one kv head a query head before the
            # kernel, as the reference (whose sharded reshape needs it)
            kq = ctx.act(_expand_kv(k, cfg.q_per_kv), "q_heads")
            vq = ctx.act(_expand_kv(v, cfg.q_per_kv), "q_heads")
        if window:
            o = _local_attention(q, kq, vq, window, ctx.use_kernel)
        else:
            o = layers.flash_attention(q, kq, vq, causal=True,
                                       use_kernel=ctx.use_kernel)
        new_cache = None
        if ctx.mode == "prefill":
            new_cache = _prefill_cache(cfg, k, v, window)
    o = o.reshape(b, t, -1)
    o = ctx.act(o, "attn_out")
    return ctx.act(o @ p["attn"]["wo"], "hidden"), new_cache


def _carry_state(cache, new, ctx):
    """A recurrent block's new state: written into the given cache in
    place at a decode step (which returns that cache), returned as is
    otherwise."""
    if ctx.mode != "decode":
        return new
    for name, value in new.items():
        cache[name].copy_(value)
    return cache


def apply_block(btype, p, x, cache, ctx):
    cfg = ctx.cfg
    aux = {}
    if btype in ("attn", "lattn", "moe"):
        window = cfg.window if btype == "lattn" else 0
        o, new_cache = _attention(p, x, cache, ctx, window)
        x = x + o
        h = layers.rmsnorm(x, p["ln2"])
        if btype != "moe":
            return x + layers.apply_mlp(p["mlp"], h, cfg), new_cache, aux
        h = ctx.act(h, "mlp_in")
        mo, aux = moe.moe_apply(p["moe"], ctx.rows(h), cfg, ctx.mesh,
                                router_bias=ctx.router_bias,
                                skip_empty=ctx.mode == "decode",
                                use_kernel=ctx.use_kernel,
                                data_axes=ctx.data_axes)
        mo = ctx.gather_rows(mo)
        if cfg.dense_ff_residual:
            mo = mo + layers.apply_mlp(p["dense"], h, cfg)
        return x + mo, new_cache, aux
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


def _train_layer(types, p_list, x, ctx):
    """One layer of a segment in train mode (the JAX package's scan
    body): x and each block's aux."""
    auxes = []
    for j, bt in enumerate(types):
        x, _, aux = apply_block(bt, p_list[j], x, None, ctx)
        auxes.append(aux)
    return x, auxes


def run_segments(params, x, caches, ctx):
    """caches: None (train/prefill) or list matching segments (decode,
    written in place).  Returns (x, caches, aux): prefill's caches are
    stacked over layers, decode's are the caches given; aux holds, per
    segment and block, `{"expert_load": (n, E) int32}` for a moe block
    and `{}` for the others.  In train mode each layer runs under
    `cfg.remat`'s checkpoint."""
    cfg = ctx.cfg
    remat = _remat(cfg) if ctx.mode == "train" else None
    all_caches, all_aux = [], []
    for si, (types, n) in enumerate(segments(cfg)):
        seg_params = _unstack(params["segments"][si], n)
        seg_cache = caches[si] if caches is not None else None
        per_layer, per_aux = [], []
        for i in range(n):
            if remat is not None:
                x, auxes = checkpoint(_train_layer, types, seg_params[i], x,
                                      ctx, use_reentrant=False, **remat)
                per_aux.append(auxes)
                continue
            ncs, auxes = [], []
            for j, bt in enumerate(types):
                c = _layer(seg_cache[j], i) if seg_cache is not None \
                    else None
                x, nc, aux = apply_block(bt, seg_params[i][j], x, c, ctx)
                ncs.append(nc)
                auxes.append(aux)
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


def _embed_in(cfg, params, batch, ctx):
    if cfg.embed_inputs:
        return params["embed"][batch["tokens"].long()]
    return batch["embeds"].to(cfg.torch_dtype)


def _positions_for(cfg, batch, t):
    if cfg.pos == "mrope":
        return batch["positions"]
    x = batch["tokens"] if "tokens" in batch else batch["embeds"]
    return torch.arange(t, device=x.device)[None, :].expand(x.shape[0], t)


def _logits(cfg, params, x, ctx):
    head = params.get("head")
    if head is None:
        head = params["embed"].T
    return x @ head


def forward(cfg, params, batch, shd=None, mode="train", use_kernel=None):
    """Full-sequence pass.  Returns (final-normed hidden (B,T,D), caches,
    aux, ctx)."""
    plan = check_plan(shd)
    batch = _on_device(params, batch)
    t = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[1]
    ctx = Ctx(cfg=cfg, mode=mode, positions=_positions_for(cfg, batch, t),
              use_kernel=use_kernel, shd=plan)
    x = _embed_in(cfg, params, batch, ctx)
    x, caches, aux = run_segments(params, x, None, ctx)
    x = layers.rmsnorm(x, params["final_norm"])
    return x, caches, aux, ctx


def loss_fn(cfg, params, batch, shd=None, use_kernel=None):
    """Next-token cross entropy (mean over the B*(T-1) predicted tokens);
    returns (loss, aux).  The targets are the inputs shifted by padding
    (T stays divisible by the chunk), the last position weighted 0.  When
    `cfg.loss_chunk` divides T, the vocab loss runs chunk by chunk, each
    under `checkpoint`, so that no (B, T, V) f32 logits are kept for the
    backward.  A MoE layer's `lb_loss` in aux would add 0.01 times its
    mean, as in the JAX package; neither package's MoE returns one (aux
    holds `expert_load` only).  Training under a plan is not ported: a
    `shd` raises."""
    if check_plan(shd) is not None:
        raise NotImplementedError(
            "loss_fn under a ShardingPlan: the sharded paths carry no "
            "gradient across ranks; train with shd=None")
    x, _, aux, ctx = forward(cfg, params, batch, use_kernel=use_kernel)
    batch = _on_device(params, batch)
    tgt = batch["tokens"] if cfg.embed_inputs else batch["labels"]
    targets = F.pad(tgt[:, 1:].long(), (0, 1))
    weights = torch.ones(targets.shape, dtype=torch.float32,
                         device=x.device)
    weights[:, -1] = 0.0

    def xent(xc, tc, wc):
        logits = _logits(cfg, params, xc, ctx).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tc[..., None])[..., 0]
        return ((logz - gold) * wc).sum()

    b, t = targets.shape
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
    lb = [a.get("lb_loss") for seg in aux for a in seg
          if isinstance(a, dict) and a.get("lb_loss") is not None]
    if lb:
        loss = loss + 0.01 * sum(torch.mean(v) for v in lb)
    return loss, aux


def prefill(cfg, params, batch, shd=None, use_kernel=None):
    """Returns (last-token logits (B,1,V), decode-ready cache, aux)."""
    x, caches, aux, ctx = forward(cfg, params, batch, shd, mode="prefill",
                                  use_kernel=use_kernel)
    x = x[:, -1:]
    return _logits(cfg, params, x, ctx), caches, aux


def decode_step(cfg, params, batch, cache, shd=None, use_kernel=None):
    """One token for every sequence.  batch: tokens/embeds (B,1,...) +
    positions (B,) [+ router_bias (E,) for MoE archs].  Writes the token's
    K/V into `cache` in place and returns (logits (B,1,V), that cache,
    aux).  Under a plan (`shd`) `cache` holds this rank's blocks
    (`init_cache(..., shd=plan)`)."""
    plan = check_plan(shd)
    batch = _on_device(params, batch)
    ctx = Ctx(cfg=cfg, mode="decode",
              positions=batch["positions"].to(torch.int32),
              use_kernel=use_kernel, router_bias=batch.get("router_bias"),
              shd=plan)
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
