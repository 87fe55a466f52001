"""Partitioning plans: where every tensor of every arch lies on the mesh.

PyTorch port of `repro.sharding.partition`.  The plan's specs are the
reference's, entry for entry: a spec is a plain tuple with one entry a
dimension, `None` (replicated), an axis name or a tuple of axis names
(that dimension split over their product), and `_fit`/`_fit_cache` drop
an axis that does not divide its dimension.  Two attention strategies
(`heads`: Megatron TP with query heads, d_ff and vocab sharded; `seq`:
sequence-parallel attention for awkward head counts) and the decode
layout (activations replicated over `model`, full KV caches sharded
batch -> data, seq -> model); FSDP shards the weights over the data axes
as well for archs above `FSDP_THRESHOLD` parameters.

What the port places by them in this slice is the explicit-collective
half of the reference, its `shard_map` sections:

* the expert weights, sharded over `model` (`shard_params`), each rank
  running its own experts (`models.moe.moe_apply_sharded`);
* the full-attention KV caches, batch over the data axes and sequence
  over `model` (`cache_specs`, `local_shape`, `shard_cache`), each rank
  attending over its block (`models.kvcache.decode_attention_sharded`).

Everything else stays whole on every rank: the dense weights (their
`param_specs` are computed, not applied) and the activations, which
`act` returns as given; that is the reference's decode layout.  Laying
out the dense weights and activations by these specs (tensor, sequence
and FSDP parallelism) is the GSPMD half, not ported yet.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.launch.mesh import flat_axes

__all__ = ["FSDP_THRESHOLD", "ShardingPlan", "map_with_path",
           "spec_leaves"]

# the reference's: FSDP for every arch above 1e9 parameters
FSDP_THRESHOLD = 1e9


def _dp(data_axes: tuple) -> Any:
    return data_axes if len(data_axes) > 1 else data_axes[0]


def map_with_path(fn, tree, path: tuple = ()):
    """`fn(name, leaf)` at every leaf of a tree of dicts and lists, `name`
    the path's keys and indices joined by "/" (the reference's
    `keystr(path, simple=True, separator="/")`)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn("/".join(str(k) for k in path), tree)


def spec_leaves(specs) -> list:
    """[(name, spec)] of a tree of specs, dict keys sorted (jax's order)."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out.append(("/".join(str(k) for k in path), node))

    walk(specs, ())
    return out


@dataclass
class ShardingPlan:
    mesh: Any          # a `launch.mesh.Mesh` (specs read only its `shape`
    cfg: Any           # and `axis_names`)
    mode: str = "train"            # train | prefill | decode
    model_axis: str = "model"
    data_axes: tuple = ("data",)
    fsdp: bool | None = None
    # "dp": pure data parallelism with ZeRO-3 (batch over every axis)
    strategy_override: str | None = None

    def __post_init__(self):
        axes = self.mesh.axis_names
        self.data_axes = tuple(a for a in axes if a != self.model_axis)
        if self.fsdp is None:
            self.fsdp = self.cfg.param_count() > FSDP_THRESHOLD
        self.strategy = (self.cfg.attn_sharding
                         if self.mode != "decode" else "decode")
        if self.strategy_override and self.mode != "decode":
            self.strategy = self.strategy_override

    # -- helpers --------------------------------------------------------
    @property
    def dp(self):
        return _dp(self.data_axes)

    def _f(self):
        """The FSDP axis (or None) for weight dim 0/1."""
        return self.dp if self.fsdp else None

    def _size(self, axes) -> int:
        return math.prod(self.mesh.shape[a] for a in flat_axes(axes))

    def _divisible(self, n: int, axes) -> bool:
        if axes is None:
            return True
        return n % self._size(axes) == 0

    # -- activation constraints ----------------------------------------
    def act(self, x, kind: str):
        """The activation as given: activations stay replicated on every
        rank in this slice (the reference's decode layout)."""
        return x

    def act_spec(self, kind: str, ndim: int = 3):
        dp, m = self.dp, self.model_axis
        if self.strategy == "dp":
            allax = tuple(self.data_axes) + (m,)
            table = {
                "hidden": (allax, None, None),
                "attn_in": (allax, None, None),
                "mlp_in": (allax, None, None),
                "q_heads": (allax, None, None, None),
                "kv_heads": (allax, None, None, None),
                "attn_out": (allax, None, None),
                "logits": (allax, None, None),
            }
            return table.get(kind)
        seq = self.strategy == "seq"
        heads = self.strategy == "heads"
        table = {
            "hidden": (dp, m, None),
            "attn_in": (dp, m if seq else None, None),
            "mlp_in": (dp, None, None),
            "q_heads": (dp, m if seq else None, m if heads else None, None),
            "kv_heads": (dp, None, None, None),
            "attn_out": (dp, m if seq else None, m if heads else None),
            "logits": (dp, None, m),
        }
        if self.mode == "decode":  # T == 1: never shard the time dim
            table.update({
                "hidden": (dp, None, None),
                "attn_in": (dp, None, None),
                "q_heads": (dp, None, None, None),
                "attn_out": (dp, None, None),
            })
        return table.get(kind)

    # -- parameter specs ------------------------------------------------
    def param_specs(self, params_shapes) -> Any:
        """A tree like `params_shapes` (any leaves with `.shape`) holding
        each leaf's spec."""
        if self.strategy == "dp":
            allax = tuple(self.data_axes) + (self.model_axis,)

            def dp_spec(name, leaf):
                if len(leaf.shape) == 0:
                    return ()
                dims = list(leaf.shape)
                big = max(range(len(dims)), key=lambda i: dims[i])
                ent = [None] * len(dims)
                if dims[big] % self._size(allax) == 0:
                    ent[big] = allax
                elif self._divisible(dims[big], self.dp):
                    ent[big] = self.dp
                return tuple(ent)

            return map_with_path(dp_spec, params_shapes)
        f = self._f()
        m = self.model_axis
        seq = self.cfg.attn_sharding == "seq"

        rules = [
            # attention
            (r"attn/w[qkv]$", (f, None) if seq else None),
            (r"attn/wq$", (f, None if seq else m)),
            (r"attn/w[kv]$", (f, None)),
            (r"attn/wo$", (None if seq else m, f)),
            (r"attn/b[qkv]$", (None,)),
            # dense mlp / arctic residual
            (r"(mlp|dense)/w[ig]$", (f, m)),
            (r"(mlp|dense)/wo$", (m, f)),
            # moe
            (r"moe/router$", (None, None)),
            (r"moe/w[ig]$", (m, f, None)),
            (r"moe/wo$", (m, None, f)),
            # rwkv time mix / channel mix
            (r"(wr|wk|wv|wg)$", (f, m)),
            (r"wo$", (m, f)),
            (r"ck$", (f, m)),
            (r"cv$", (m, f)),
            (r"cr$", (f, None)),
            (r"lora_a$", (f, None)),
            (r"lora_b$", (None, None)),
            (r"(u|ln_o|ln_o_b)$", (m, None)),
            (r"(w0|mu|mu_cm)$", (None,)),
            # rg-lru
            (r"rec/wx$", (f, m)),
            (r"rec/wgate$", (f, m)),
            (r"rec/wout$", (m, f)),
            (r"rec/conv$", (None, m)),
            (r"rec/(w_r|b_r|w_i|b_i|lam)$", (m,)),
            # embeddings / head
            (r"^embed$", (m, None)),
            (r"^head$", (f, m)),
            (r"(ln1|ln2|final_norm)$", (None,)),
        ]

        def spec_for(name, leaf):
            clean = re.sub(r"/\d+", "", name)
            clean = re.sub(r"/(r|c)$", "", clean)
            stacked = "segments" in name
            for pat, spec in rules:
                if spec is None:
                    continue
                if re.search(pat, clean):
                    return self._fit(spec, tuple(leaf.shape), stacked)
            return (None,) * len(leaf.shape)

        return map_with_path(spec_for, params_shapes)

    def _fit(self, spec: tuple, shape, stacked: bool) -> tuple:
        """Prepend None for the stacked layer dim, pad to rank, and drop
        axes that do not divide the dimension."""
        entries = list(spec)
        if stacked:
            entries = [None] + entries
        return self._fit_cache(tuple(entries), shape)

    # -- inputs / cache --------------------------------------------------
    def cache_specs(self, cache_shapes):
        """Full attn caches: (n, B, S, K, dh) -> (None, dp, model, ...);
        everything else: batch over data, channel/head dims over model
        where divisible."""
        dp, m = self.dp, self.model_axis

        def spec_for(name, leaf):
            shape = tuple(leaf.shape)
            if re.search(r"/(k|v)$", name):
                if shape[2] > max(self.cfg.window, 1):  # full cache
                    return self._fit_cache((None, dp, m, None, None), shape)
                return self._fit_cache((None, dp, None, None, None), shape)
            if re.search(r"/s$", name):      # rwkv state (n,B,H,N,N)
                return self._fit_cache((None, dp, m, None, None), shape)
            if re.search(r"/h$", name):      # rg-lru (n,B,W)
                return self._fit_cache((None, dp, m), shape)
            if re.search(r"/conv$", name):   # (n,B,cw-1,W)
                return self._fit_cache((None, dp, None, m), shape)
            return self._fit_cache((None, dp), shape)

        return map_with_path(spec_for, cache_shapes)

    def _fit_cache(self, spec: tuple, shape) -> tuple:
        entries = list(spec)
        while len(entries) < len(shape):
            entries.append(None)
        entries = entries[:len(shape)]
        return tuple(None if ax is not None and not self._divisible(dim, ax)
                     else ax for dim, ax in zip(shape, entries))

    # -- this rank's blocks ---------------------------------------------
    def block(self, dim: int, entry) -> slice:
        """This rank's slice of a dimension of `dim` split over `entry`."""
        if entry is None:
            return slice(None)
        n = self.mesh.axis_size(entry)
        if dim % n:
            raise ValueError(f"a dimension of {dim} does not split over "
                             f"{entry!r} ({n} ranks)")
        i = self.mesh.axis_index(entry)
        return slice(i * (dim // n), (i + 1) * (dim // n))

    def local_shape(self, shape, spec) -> tuple:
        """The shape of this rank's block of a leaf of `shape`."""
        return tuple(d if e is None else d // self.mesh.axis_size(e)
                     for d, e in zip(shape, spec))

    def local_shard(self, leaf: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of `leaf` under `spec` (a view)."""
        return leaf[tuple(self.block(d, e)
                          for d, e in zip(leaf.shape, spec))]

    def _expert_spec(self, name: str, leaf):
        """The reference's shard_map spec of an expert weight (experts
        over `model`), or None for any other leaf."""
        if not re.search(r"moe/w[igo]$", re.sub(r"/\d+", "", name)):
            return None
        return ((None,) * (len(leaf.shape) - 3)
                + (self.model_axis, None, None))

    def shard_params(self, params):
        """`params` with each expert weight cut to this rank's experts (a
        view), every other leaf whole."""
        def one(name, leaf):
            spec = self._expert_spec(name, leaf)
            return leaf if spec is None else self.local_shard(leaf, spec)
        return map_with_path(one, params)

    def _kv_spec(self, name: str, shape):
        """The spec of a full-attention K/V leaf of global `shape` (batch
        over data, sequence over `model`), or None for a leaf that stays
        whole."""
        shape = tuple(shape)
        if not (re.search(r"/(k|v)$", name)
                and shape[2] > max(self.cfg.window, 1)):
            return None
        want = (None, self.dp, self.model_axis, None, None)
        spec = self._fit_cache(want, shape)
        if spec != want:
            raise ValueError(
                f"cache leaf {name} of shape {shape} does not split as "
                f"{want} over {self.mesh.shape}: the sequence-sharded decode "
                f"needs its batch divisible by the data axes and its length "
                f"by {self.model_axis!r}")
        return spec

    def local_cache_shape(self, name: str, leaf) -> tuple:
        """The shape this rank holds of cache leaf `name` (global `leaf`):
        a full-attention K/V leaf's block, any other leaf whole."""
        shape = tuple(leaf.shape)
        spec = self._kv_spec(name, shape)
        return shape if spec is None else self.local_shape(shape, spec)

    def shard_cache(self, cache):
        """`cache` with each full-attention K/V leaf cut to this rank's
        block (a view), every other leaf whole."""
        def one(name, leaf):
            spec = self._kv_spec(name, leaf.shape)
            return leaf if spec is None else self.local_shard(leaf, spec)
        return map_with_path(one, cache)

    def cache_block(self, name: str, leaf_shape) -> tuple | None:
        """(batch slice, sequence slice) of a full-attention K/V leaf of
        global `leaf_shape` that this rank holds, or None for a leaf held
        whole."""
        spec = self._kv_spec(name, leaf_shape)
        if spec is None:
            return None
        return (self.block(leaf_shape[1], spec[1]),
                self.block(leaf_shape[2], spec[2]))
