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

The reference hands these specs to GSPMD, which places every tensor and
inserts the collectives.  Here every rank is a process holding its
blocks, and the plan places them itself:

* weights: `shard_params` cuts every leaf by `param_specs` (views):
  column- and row-parallel attention and MLP weights over `model`
  (`heads`), RG-LRU's and RWKV's projections, gates and per-head
  leaves over `model` by channel or head (RWKV's LoRAs, mixes and
  channel-mix gate `cr` whole), the experts over `model`, the
  vocab-sharded embedding and head, and every weight over the data
  axes under FSDP.  `gather_data` puts a layer's FSDP blocks back
  together over the data axes just before the layer runs (its `model`
  blocks stay);
* activations: `act(x, kind, have, partial)` relayouts a rank's block
  from the spec it has (`have`; whole when None) to `act_spec(kind)`
  fitted to the tensor's global shape, the reference's
  `with_sharding_constraint`: slicing where a dimension becomes split,
  `all_gather` where it stops being split, and a pending sum over
  `partial` (a row-parallel product's) reduce-scattered into the
  dimension that becomes split over those axes, else all-reduced
  (`relayout` is the general move between two specs);
* inputs: `input_shardings` gives each input's spec (rows over the data
  axes), `shard_inputs` cuts a whole batch to this rank's rows;
* caches: every leaf by `cache_specs` (`local_cache_shape`,
  `shard_cache`, `cache_block`): the full-attention K/V batch over the
  data axes and sequence over `model`, each rank attending over its
  block (`models.kvcache.decode_attention_sharded`); the window K/V of
  local attention and RWKV's token shifts rows only; the recurrent
  states rows over the data axes with RG-LRU's `h` and `conv` channels
  and RWKV's `s` heads over `model`, each rank scanning its channels or
  heads.

Every block type serves and trains under a plan.  The optimizer's m, v
and master are cut by the plan with FSDP forced on (`zero1`, the
reference's ZeRO-1 specs): over the data axes even where the weights are
not (`shard_state` cuts a whole train state into a rank's blocks).

The "dp" strategy (`strategy_override="dp"`, every mode but decode) is
pure data parallelism with ZeRO-3: every leaf cut on its largest
dimension over every axis (or over the data axes where only they
divide it), the batch's rows and every activation's over every axis.
`gather_data` gathers such a leaf whole (its entry holds a data axis)
and `compute_spec` drops it, so the layers, the embedding, the final
norm and the head run on whole weights and the rank's rows, and the
gathers' adjoints sum each leaf's gradient into its block.

Training: each rank runs a function of its own blocks, and its gradients
are its terms of the reference's when three things hold.

1. The loss is counted once: the ranks' local losses sum to the global
   loss, each predicted token's term on exactly one rank (a term that
   every rank of an axis computes alike counts on the rank of index 0,
   or on the rank whose block of the sequence holds its token).
2. Each collective's backward is its transpose on the same group
   (`launch.mesh`): all_gather <-> reduce_scatter, all_reduce (sum) <->
   all_reduce (sum); a detached all_reduce (max) carries none.  Local
   slices and masked picks need nothing: autograd has them.  So the
   gradient a rank holds of a tensor that it shares with other ranks
   (replicated over their axes) is its term of the sum over them.
3. Each leaf's gradient is summed over the mesh axes its spec leaves
   replicated (`grad_block`): after the backward, leaf by leaf in tree
   order on every rank, never from hooks (every rank issues the same
   collectives in one order; remat's recompute re-issues a layer's
   gathers inside the backward).  An FSDP leaf has its data sum from
   `gather_data`'s all_gather adjoint; a leaf that ZeRO-1 alone cuts
   over the data axes takes its data sum as a reduce_scatter into its
   block; the other axes are all-reduced.
"""
from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.analysis import cost
from repro_torch.launch.mesh import flat_axes

__all__ = ["FSDP_THRESHOLD", "ShardingPlan", "map_with_path",
           "spec_leaves", "state_spec_leaves", "zip_map"]

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


def zip_map(fn, tree, specs):
    """`fn(leaf, spec)` at every leaf of a tree of dicts and lists and
    the spec at the same place of `specs` (a spec is a tuple: a leaf)."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [zip_map(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


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


def state_spec_leaves(specs) -> list:
    """The specs of a tree of specs in jax's flatten order (`leaves`' of
    the tree they describe): a NamedTuple of spec trees, such as a
    `TrainState` of specs, field by field, None no leaf."""
    if specs is None:
        return []
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return [s for f in specs for s in state_spec_leaves(f)]
    return [s for _, s in spec_leaves(specs)]


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
    _model_specs: Any = field(default=None, init=False, repr=False,
                              compare=False)

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
    def act(self, x, kind: str, have=None, partial=None):
        """This rank's block of activation `x` laid out by
        `act_spec(kind)`, fitted to x's global shape (an axis that does
        not divide its dimension is dropped, as the reference's `act`
        does).  x is this rank's block under `have` (None: the whole
        tensor), and with `partial` (axes) a pending sum over those
        axes, which this sums.  A kind without a spec keeps `have`."""
        if x is None:
            return x
        have = self._pad(have, x.dim())
        shape = self.global_shape(x.shape, have)
        want = have if self.act_spec(kind, x.dim()) is None \
            else self.spec(kind, shape)
        return self.relayout(x, have, want, partial)

    def spec(self, kind: str, shape) -> tuple:
        """`act_spec(kind)` fitted to a global `shape` (replicated for a
        kind without one): the spec `act` lays such a tensor out by."""
        spec = self.act_spec(kind, len(shape))
        if spec is None:
            return (None,) * len(shape)
        return self._fit_cache(spec, tuple(shape))

    @staticmethod
    def _pad(spec, ndim: int) -> tuple:
        spec = tuple(spec or ())
        return (spec + (None,) * ndim)[:ndim]

    def global_shape(self, shape, spec) -> tuple:
        """The global shape of which a block of `shape` is one under
        `spec` (a fitted spec)."""
        return tuple(d * self._size(e)
                     for d, e in zip(shape, self._pad(spec, len(shape))))

    def relayout(self, x: torch.Tensor, have, want, partial=None
                 ) -> torch.Tensor:
        """x, this rank's block under spec `have`, as its block under
        `want` (both fitted to the global shape).  A pending sum over
        `partial` is reduce-scattered into the dimension `want` splits
        over exactly those axes and `have` does not, or else
        all-reduced; then every dimension split differently is
        all-gathered and every dimension `want` splits is sliced (a
        view)."""
        nd = x.dim()
        have = list(self._pad(have, nd))
        want = self._pad(want, nd)
        same = lambda a, b: flat_axes(a) == flat_axes(b)
        if partial is not None and self._size(partial) > 1:
            dim = next((d for d in range(nd) if have[d] is None
                        and want[d] is not None and same(want[d], partial)),
                       None)
            if dim is None:
                x = self.mesh.all_reduce(x, partial)
            else:
                x = self.mesh.reduce_scatter(x, partial, dim)
                have[dim] = want[dim]
        for d in range(nd):
            if have[d] is not None and not same(have[d], want[d]):
                if self._size(have[d]) > 1:
                    x = self.mesh.all_gather(x, have[d], dim=d)
                have[d] = None
        for d in range(nd):
            if want[d] is not None and have[d] is None:
                x = x[(slice(None),) * d + (self.block(x.shape[d], want[d]),)]
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
        return map_with_path(lambda name, leaf: self.cache_spec(
            name, tuple(leaf.shape)), cache_shapes)

    def cache_spec(self, name: str, shape) -> tuple:
        """The spec of the cache leaf at `name` (its path, as
        `map_with_path` names it) of global `shape`."""
        dp, m = self.dp, self.model_axis
        shape = tuple(shape)
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
        return tuple(d // self._size(e) for d, e in zip(shape, spec))

    def local_shard(self, leaf: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of `leaf` under `spec` (a view)."""
        return leaf[tuple(self.block(d, e)
                          for d, e in zip(leaf.shape, spec))]

    # -- weights ---------------------------------------------------------
    def param_shardings(self, params_shapes):
        """The spec of every leaf (`param_specs`): where the reference
        builds a `NamedSharding` of each, a rank's block is its
        `local_shard` under it."""
        return self.param_specs(params_shapes)

    def shard_params(self, params):
        """`params` (whole tensors) with every leaf cut to this rank's
        block by `param_specs` (views: clone them to free the whole
        tree)."""
        return zip_map(self.local_shard, params,
                       self.param_shardings(params))

    def model_specs(self):
        """`param_specs` of the plan's model (`cfg`'s parameter tree at
        full shape), computed once."""
        if self._model_specs is None:
            # the models import this module; the shapes are plumbing, not
            # a step's work (a counter on meta would count their draws)
            from repro_torch.models import transformer
            with cost.uncounted():
                self._model_specs = self.param_specs(
                    transformer.init_params(self.cfg, torch.Generator(),
                                            "meta"))
        return self._model_specs

    def _is_data(self, entry) -> bool:
        return any(a in self.data_axes for a in flat_axes(entry))

    def gather_data(self, leaf: torch.Tensor, spec) -> torch.Tensor:
        """A weight's block under `spec` with every dimension split over
        data axes (FSDP) all-gathered: the block the rank computes with,
        laid out by `compute_spec(spec)`."""
        for d, e in enumerate(spec):
            if self._is_data(e) and self._size(e) > 1:
                leaf = self.mesh.all_gather(leaf, e, dim=d)
        return leaf

    def compute_spec(self, spec) -> tuple:
        """`spec` without its data axes: the layout of `gather_data`'s
        result."""
        return tuple(None if self._is_data(e) else e for e in spec)

    # -- training: ZeRO-1 and the gradients' sums -------------------------
    def zero1(self) -> "ShardingPlan":
        """This plan with FSDP forced on: its `param_specs` are the specs
        of the optimizer's m, v and master (ZeRO-1), as the reference's
        train step builds them."""
        plan = dataclasses.replace(self)
        plan.fsdp = True
        return plan

    def replicated_axes(self, spec) -> tuple:
        """The mesh axes of more than one rank that split no dimension of
        `spec`: those a leaf under it is replicated over."""
        used = {a for e in spec for a in flat_axes(e)}
        return tuple(a for a in self.mesh.axis_names
                     if a not in used and self.mesh.shape[a] > 1)

    def grad_block(self, g: torch.Tensor, spec, zspec) -> torch.Tensor:
        """A leaf's gradient: `g`, this rank's term of it on its block
        under `spec`, summed over the axes `spec` leaves replicated, as
        this rank's block under `zspec` (its ZeRO-1 spec: `spec` with at
        most one dimension more split over the data axes).  The sum over
        the axes `zspec` adds is reduce-scattered into that dimension,
        the rest all-reduced."""
        dim = next((d for d, (a, b) in enumerate(zip(spec, zspec))
                    if flat_axes(a) != flat_axes(b)), None)
        scatter = () if dim is None else flat_axes(zspec[dim])
        if scatter:
            g = self.relayout(g, spec, zspec, partial=scatter)
        rest = tuple(a for a in self.replicated_axes(spec)
                     if a not in scatter)
        return self.mesh.all_reduce(g, rest) if rest else g

    def shard_state(self, state, specs):
        """A whole train state (a NamedTuple of trees: step, params, m, v,
        master) cut to this rank's blocks by `specs` (the same NamedTuple
        of spec trees, `train.step.state_shardings`; views)."""
        return type(state)(*(None if t is None else
                             zip_map(self.local_shard, t, s)
                             for t, s in zip(state, specs)))

    # -- inputs ----------------------------------------------------------
    def input_shardings(self, specs: dict) -> dict:
        """The spec of every input of a batch: rows over the data axes
        (over every axis under the "dp" strategy) where they divide.
        `specs` maps a name to anything with `.shape`, or to a `(shape,
        dtype)` pair as `cfg.input_specs` gives."""
        dp = self.dp
        if self.strategy == "dp":
            dp = tuple(self.data_axes) + (self.model_axis,)
        out = {}
        for k, v in specs.items():
            shape = tuple(v.shape if hasattr(v, "shape") else v[0])
            out[k] = self._fit_cache((dp,) + (None,) * (len(shape) - 1),
                                     shape)
        return out

    def shard_inputs(self, batch: dict) -> dict:
        """This rank's block of every input of `batch` (whole tensors) by
        `input_shardings` (views)."""
        specs = self.input_shardings(batch)
        return {k: self.local_shard(v, specs[k]) for k, v in batch.items()}

    def _kv_spec(self, name: str, shape):
        """The spec of cache leaf `name` of global `shape` by `cache_spec`;
        raises for a full-attention K/V leaf that does not split as
        (batch over data, sequence over `model`)."""
        shape = tuple(shape)
        spec = self.cache_spec(name, shape)
        if not (re.search(r"/(k|v)$", name)
                and shape[2] > max(self.cfg.window, 1)):
            return spec
        want = (None, self.dp, self.model_axis, None, None)
        if spec != want:
            raise ValueError(
                f"cache leaf {name} of shape {shape} does not split as "
                f"{want} over {self.mesh.shape}: the sequence-sharded decode "
                f"needs its batch divisible by the data axes and its length "
                f"by {self.model_axis!r}")
        return spec

    def local_cache_shape(self, name: str, leaf) -> tuple:
        """The shape of this rank's block of cache leaf `name` (global
        `leaf`) by `cache_spec`."""
        shape = tuple(leaf.shape)
        return self.local_shape(shape, self._kv_spec(name, shape))

    def shard_cache(self, cache):
        """`cache` (whole leaves) with every leaf cut to this rank's block
        by `cache_specs` (views)."""
        return map_with_path(lambda name, leaf: self.local_shard(
            leaf, self._kv_spec(name, leaf.shape)), cache)

    def cache_block(self, name: str, leaf_shape) -> tuple:
        """This rank's slice of every dimension of cache leaf `name` of
        global `leaf_shape`, by `cache_spec`."""
        spec = self._kv_spec(name, leaf_shape)
        return tuple(slice(*self.block(d, e).indices(d))
                     for d, e in zip(leaf_shape, spec))
