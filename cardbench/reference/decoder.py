"""Plain PyTorch reference of the decoders that cardbench's configurations
run, written from the models' definitions: a pre-norm GQA transformer
(granite-3-2b) and one whose every layer adds a dense FFN and a top-k
mixture of experts to its attention (arctic-480b).

    x = embed[tokens]
    per layer:  x = x + attn(rmsnorm(x, ln1)) @ wo
                h = rmsnorm(x, ln2)
                x = x + mlp(h)                       (dense)
                x = x + moe(h) + dense_mlp(h)        (MoE + dense residual)
    logits = rmsnorm(x, final_norm) @ head           (embed.T when tied)

rmsnorm scales by (1 + scale), eps 1e-6; RoPE rotates the two halves of a
head (theta from the configuration); query head i reads kv head i // (H /
KH); scores are scaled by Dh^-0.5; mlp = (silu(h wg) * (h wi)) wo.  The
router's logits are h @ router; a token takes its top_k experts (a decoded
token may be told which to take, `sequences`), gated by the softmax of
their logits.  At a prefill of T tokens each expert holds
C = max(8, ceil8(int(T * top_k * capacity_factor / E))) assignments, first
come first served in token order, and the rest are dropped; a decoded
token is never dropped (the port decodes at most C rows a step).

Numerics: "f32" computes every product in float32 with TF32 off; "fp8"
(the control) rounds both operands of every product to float8 e4m3 with
one scale a tensor (a straight-through rounding in training).

It imports neither jax, the JAX package nor the port, and takes only the
weights and the tokens the benchmark made.  Training follows the port's
AdamW (global-norm clipping, bias-corrected moments, decoupled weight
decay off norms, cosine schedule with warmup).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cardbench.tree import flatten

FP8_MAX = 448.0
# substrings of a leaf's path that exempt it from weight decay
NO_DECAY = ("ln1", "ln2", "final_norm", "mu", "w0", "lam", "b_r", "b_i",
            "ln_o")


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32: TF32 off while the block runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def q8(x: torch.Tensor, mode: str) -> torch.Tensor:
    """x as the mode computes with it: itself ("f32"), or rounded to float8
    e4m3 with one scale for the tensor ("fp8"; the gradient passes
    through)."""
    if mode == "f32":
        return x
    if mode != "fp8":
        raise ValueError(f"mode {mode!r}: f32 or fp8")
    xd = x.detach()
    s = xd.abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (xd / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - xd) if x.requires_grad else q


def mm(a, b, mode):
    return q8(a, mode) @ q8(b, mode)


def rmsnorm(x, scale, eps: float = 1e-6):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, pos, theta: float):
    """x (..., N, H, Dh) at positions pos (N,)."""
    dh = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                          device=x.device) / dh))
    ang = pos.to(torch.float64)[:, None] * freqs          # (N, Dh/2)
    cos = torch.cos(ang).to(x.dtype)[:, None, :]
    sin = torch.sin(ang).to(x.dtype)[:, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, mode, q_pos=None, chunk: int = 1024):
    """Causal GQA attention.  q (B, Nq, H, Dh), k/v (B, Nk, KH, Dh); query
    i sits at position q_pos[i] (default: the last Nq of the keys'), and
    sees keys 0..q_pos[i]."""
    b, nq, h, dh = q.shape
    nk, kh = k.shape[1], k.shape[2]
    g = h // kh
    if q_pos is None:
        q_pos = torch.arange(nk - nq, nk, device=q.device)
    ke = q8(k.repeat_interleave(g, dim=2), mode)
    ve = q8(v.repeat_interleave(g, dim=2), mode)
    kpos = torch.arange(nk, device=q.device)
    outs = []
    for lo in range(0, nq, chunk):
        qc = q8(q[:, lo:lo + chunk], mode)
        s = torch.einsum("bqhd,bkhd->bhqk", qc, ke) * dh ** -0.5
        vis = kpos[None, :] <= q_pos[lo:lo + chunk, None]
        s = s.masked_fill(~vis[None, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", q8(p, mode), ve))
    return torch.cat(outs, dim=1)


def mlp(h, p, mode):
    return mm(F.silu(mm(h, p["wg"], mode)) * mm(h, p["wi"], mode),
              p["wo"], mode)


def capacity(n_tokens: int, m: dict) -> int:
    c = int(n_tokens * m["top_k"] * m["capacity_factor"] / m["num_experts"])
    return max(8, -(-c // 8) * 8)


def _layer(weights: dict, i: int, dev) -> dict:
    """Layer i of the stacked block, in float32 on `dev` (the experts stay
    as they are and are widened one at a time)."""
    blk = weights["segments"][0][0]
    out = {}
    for k, sub in blk.items():
        if k == "moe":
            out[k] = {n: t[i] for n, t in sub.items()}
        elif isinstance(sub, dict):
            out[k] = {n: t[i].to(dev, torch.float32) for n, t in sub.items()}
        else:
            out[k] = sub[i].to(dev, torch.float32)
    return out


# ---------------------------------------------------------------------------
# the weights both sides take
# ---------------------------------------------------------------------------

def draw(model: dict, seed: int, device, dtype=None) -> dict:
    """The configuration's weights, drawn on `device` from the seed: the
    port's tree (`embed`, `segments[0][0]` with every leaf stacked over
    the layers, `final_norm`, `head` when the embedding is not tied) and
    scales (d^-0.5 for inputs, the fan-in^-0.5 for outputs, norms at
    zero), in the working dtype (the router and the norms in float32).
    Each leaf is one call over all its layers; the same seed gives the
    same tensors.  Only "attn" and "moe" blocks are drawn."""
    dt = getattr(torch, model["dtype"]) if dtype is None else dtype
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    d, f, v, n = (model["d_model"], model["d_ff"], model["vocab"],
                  model["num_layers"])
    h, kh, dh = model["num_heads"], model["num_kv_heads"], model["head_dim"]

    def normal(shape, scale, kind=dt):
        return torch.randn(shape, generator=g, dtype=kind,
                           device=dev).mul_(scale)

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def mlp(width):
        return {"wi": normal((n, d, width), d ** -0.5),
                "wg": normal((n, d, width), d ** -0.5),
                "wo": normal((n, width, d), width ** -0.5)}

    tree = {"embed": normal((v, d), d ** -0.5)}
    block = {"ln1": zeros((n, d)), "ln2": zeros((n, d)),
             "attn": {"wq": normal((n, d, h * dh), d ** -0.5),
                      "wk": normal((n, d, kh * dh), d ** -0.5),
                      "wv": normal((n, d, kh * dh), d ** -0.5),
                      "wo": normal((n, h * dh, d), (h * dh) ** -0.5)}}
    if model.get("num_experts", 0):
        if model.get("moe_every", 1) != 1:
            raise NotImplementedError("only every-layer MoE is drawn")
        if model.get("dense_ff_residual"):
            block["dense"] = mlp(model["dense_ff_residual"])
        e = model["num_experts"]
        block["moe"] = {"router": normal((n, d, e), d ** -0.5, torch.float32),
                        "wi": normal((n, e, d, f), d ** -0.5),
                        "wg": normal((n, e, d, f), d ** -0.5),
                        "wo": normal((n, e, f, d), f ** -0.5)}
    else:
        block["mlp"] = mlp(f)
    tree["segments"] = [[block]]
    tree["final_norm"] = zeros((d,))
    if not model.get("tie_embeddings", False):
        tree["head"] = normal((d, v), d ** -0.5)
    return tree


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _train_layer(x, lw, pos, m, mode):
    b, t, _ = x.shape
    h, kh, dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    y = rmsnorm(x, lw["ln1"])
    a = lw["attn"]
    q = rope(mm(y, a["wq"], mode).view(b, t, h, dh), pos, m["rope_theta"])
    k = rope(mm(y, a["wk"], mode).view(b, t, kh, dh), pos, m["rope_theta"])
    v = mm(y, a["wv"], mode).view(b, t, kh, dh)
    o = attention(q, k, v, mode)
    x = x + mm(o.reshape(b, t, h * dh), a["wo"], mode)
    return x + mlp(rmsnorm(x, lw["ln2"]), lw["mlp"], mode)


def _unstack(tree, n):
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def loss(m: dict, params: dict, tokens: torch.Tensor, mode: str):
    """Mean next-token cross entropy over the B x (T - 1) predicted
    tokens; each layer checkpointed (recomputed in the backward)."""
    if m.get("num_experts", 0):
        raise NotImplementedError("the reference trains dense models only")
    b, t = tokens.shape
    pos = torch.arange(t, device=tokens.device)
    x = params["embed"][tokens.long()]
    for lw in _unstack(params["segments"][0][0], m["num_layers"]):
        x = checkpoint(_train_layer, x, lw, pos, m, mode,
                       use_reentrant=False)
    x = rmsnorm(x, params["final_norm"])
    head = params.get("head")
    w = params["embed"].T if head is None else head
    logits = mm(x[:, :-1], w, mode)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long(),
                           reduction="sum") / (b * (t - 1))


def lr_at(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup"], 1), 1.0)
    if opt.get("schedule", "cosine") == "cosine":
        frac = min(max((step - opt["warmup"]) /
                       max(opt["total_steps"] - opt["warmup"], 1), 0.0), 1.0)
        base = 0.5 * (1 + math.cos(math.pi * frac))
    else:
        base = 1.0
    return opt["lr"] * warm * base


def _tree_like(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_like(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_like(v, fn) for v in tree]
    return fn(tree)


def train(m: dict, weights: dict, batches: list, opt: dict,
          mode: str = "f32") -> dict:
    """AdamW steps from `weights` (float32 copies of them; `weights`
    itself is left as drawn), one a batch.  Returns the loss of each step,
    each leaf's norm of the first step's gradient as the optimizer takes
    it (clipped), and each leaf's norm of its change after the last
    step."""
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    with exact_f32():
        params = _tree_like(weights, lambda w: w.detach().to(
            torch.float32, copy=True).requires_grad_())
        leaves = flatten(params)
        mom = [torch.zeros_like(p) for _, p in leaves]
        vel = [torch.zeros_like(p) for _, p in leaves]
        losses, grad_norm = [], {}
        for step, tokens in enumerate(batches, start=1):
            value = loss(m, params, tokens, mode)
            grads = torch.autograd.grad(value, [p for _, p in leaves])
            losses.append(float(value.detach()))
            del value
            with torch.no_grad():
                gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                                      for g in grads))
                scale = min(opt["clip_norm"] / max(gnorm, 1e-12), 1.0)
                lr = lr_at(opt, step)
                b1c, b2c = 1 - b1 ** step, 1 - b2 ** step
                for (path, p), g, mo, ve in zip(leaves, grads, mom, vel):
                    g = g * scale
                    if step == 1:
                        grad_norm[path] = float(torch.linalg.vector_norm(
                            g.double()))
                    mo.mul_(b1).add_(g * (1 - b1))
                    ve.mul_(b2).add_(g * g * (1 - b2))
                    delta = (mo / b1c) / (torch.sqrt(ve / b2c) + eps)
                    if p.dim() >= 2 and not any(s in path for s in NO_DECAY):
                        delta = delta + p * opt["weight_decay"]
                    p.sub_(delta * lr)
            del grads
        change = {path: float(torch.linalg.vector_norm(
            (p.detach() - w.float()).double()))
            for (path, p), (_, w) in zip(leaves, flatten(weights))}
    return {"loss": losses, "grad_norm": grad_norm, "change_norm": change}


# ---------------------------------------------------------------------------
# serving: prefill then decode, as one causal pass over each sequence
# ---------------------------------------------------------------------------

def _route(h, router, m, mode, follow=None):
    """Top-k expert ids of rows h (N, D), their gates (the softmax of
    their router logits) and each row's route gap.  With `follow` (M, k),
    the last M rows take those ids instead, and their route gap is how far
    the lowest of those experts' logits lies below the k-th best (0 where
    they are the top k); the others' is 0."""
    logits = mm(h, router, mode)
    ids = torch.topk(logits, m["top_k"], dim=-1).indices
    route_gap = torch.zeros(h.shape[0], device=h.device)
    if follow is not None and follow.shape[0]:
        n = follow.shape[0]
        ids = torch.cat([ids[:-n], follow.to(ids.device)])
        kth = torch.topk(logits[-n:], m["top_k"], dim=-1).values[:, -1]
        taken = logits[-n:].gather(1, ids[-n:]).min(dim=-1).values
        route_gap[-n:] = (kth - taken).clamp(min=0)
    gates = torch.softmax(logits.gather(1, ids), dim=-1)
    return ids, gates, route_gap


def _experts(h, ids, gates, kept, moe, mode):
    """sum over kept assignments of gate * expert(h), rows h (R, D)."""
    out = torch.zeros_like(h)
    for e in range(moe["wi"].shape[0]):
        rows, slot = torch.nonzero((ids == e) & kept, as_tuple=True)
        if rows.numel() == 0:
            continue
        w = {"wi": moe["wi"][e].float(), "wg": moe["wg"][e].float(),
             "wo": moe["wo"][e].float()}
        out.index_add_(0, rows, mlp(h[rows], w, mode) *
                       gates[rows, slot][:, None])
    return out


def sequences(m: dict, weights: dict, seqs: list, mode: str = "f32",
              follow: list | None = None) -> dict:
    """Logits of every decoded position of each (prompt, served tokens)
    pair: the served tokens fed after the prompt's last token fed again,
    as a decode step feeds them, so position T + j gives the logits that
    chose served token j.  The prompt's T tokens share each expert's
    capacity (first come, first served, as one prefill of them); a decoded
    token is never dropped.  The prompt takes the reference's own routing;
    the decoded positions of sequence s take `follow[s]` ((n, layers, k)
    expert ids) where it is given, else their own.

    Returns {"logits": per sequence (n, V) f32, "routes": per sequence the
    (n, layers, k) expert ids its decoded positions took (None without
    experts), "route_gap": per sequence (n,), the largest over the layers
    of how far a followed expert's router logit lies below the k-th best
    (zeros without `follow`)}."""
    dev = weights["final_norm"].device
    h_, kh, dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    moe_on = bool(m.get("num_experts", 0))
    reqs = []
    for prompt, served in seqs:
        prompt = torch.as_tensor(prompt, device=dev).long()
        fed = torch.cat([prompt, prompt[-1:],
                         torch.as_tensor(served[:-1], device=dev).long()])
        reqs.append({"t": len(prompt), "x": weights["embed"][fed].float(),
                     "routes": [], "route_gap": torch.zeros(
                         len(served), device=dev)})
    with torch.no_grad(), exact_f32():
        for i in range(m["num_layers"]):
            lw = _layer(weights, i, dev)
            a = lw["attn"]
            for r in reqs:
                n = r["x"].shape[0]
                pos = torch.arange(n, device=dev)
                y = rmsnorm(r["x"], lw["ln1"])
                q = rope(mm(y, a["wq"], mode).view(n, h_, dh), pos,
                         m["rope_theta"])
                k = rope(mm(y, a["wk"], mode).view(n, kh, dh), pos,
                         m["rope_theta"])
                v = mm(y, a["wv"], mode).view(n, kh, dh)
                o = attention(q[None], k[None], v[None], mode)[0]
                r["x"] = r["x"] + mm(o.reshape(n, h_ * dh), a["wo"], mode)
            if not moe_on:
                for r in reqs:
                    r["x"] = r["x"] + mlp(rmsnorm(r["x"], lw["ln2"]),
                                          lw["mlp"], mode)
                continue
            rows, ids, gates, kept = [], [], [], []
            for s_, r in enumerate(reqs):   # every request's rows at once
                t = r["t"]
                hh = rmsnorm(r["x"], lw["ln2"])
                sel, g, rgap = _route(
                    hh, lw["moe"]["router"], m, mode,
                    None if follow is None else follow[s_][:, i])
                r["routes"].append(sel[t:])
                r["route_gap"] = torch.maximum(r["route_gap"], rgap[t:])
                flat = sel[:t].reshape(-1)
                onehot = (flat[:, None] == torch.arange(
                    m["num_experts"], device=dev)).to(torch.int64)
                before = (torch.cumsum(onehot, 0) - onehot).gather(
                    1, flat[:, None])[:, 0]
                keep = torch.ones_like(sel, dtype=torch.bool)
                keep[:t] = (before < capacity(t, m)).view(t, -1)
                rows.append(hh)
                ids.append(sel)
                gates.append(g)
                kept.append(keep)
            hall = torch.cat(rows)
            upd = _experts(hall, torch.cat(ids), torch.cat(gates),
                           torch.cat(kept), lw["moe"], mode)
            if "dense" in lw:
                upd = upd + mlp(hall, lw["dense"], mode)
            at = 0
            for r, hrow in zip(reqs, rows):
                r["x"] = r["x"] + upd[at:at + hrow.shape[0]]
                at += hrow.shape[0]
        head = weights.get("head")
        w = (weights["embed"].T if head is None else head).float()
        fin = weights["final_norm"].float()
        out = [mm(rmsnorm(r["x"][r["t"]:], fin), w, mode) for r in reqs]
    return {"logits": out,
            "routes": [torch.stack(r["routes"], dim=1) if r["routes"]
                       else None for r in reqs],
            "route_gap": [r["route_gap"] for r in reqs]}


def gap(logits: torch.Tensor, token: int) -> float:
    """How far `token`'s logit lies below the best of `logits` (V,)."""
    return float(logits.max() - logits[token])
