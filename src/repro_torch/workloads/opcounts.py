"""OpCount accounting: model-zoo configs -> per-op instruction-mix tables.

PyTorch port of `repro.workloads.opcounts`.  The `OpCount` container, the
isa group maps and the phase constants are the reference's.  What
changes is the source of the counts: the JAX package walks XLA's
optimized HLO (`opcount_from_hlo` over the XLA-only `analysis/hlo.py`);
the port runs the torch model under `opcount_from_torch`, a
`TorchDispatchMode` that charges every executed aten op to an isa group
with the same maps and the same rules:

  * elementwise ops charge their output elements, under the HLO op name
    they lower to (`ATEN_TO_HLO`), classed by dtype as `hlo._dtype_class`
    does: float/complex is `f`, integer/bool `i`; a comparison or a
    select takes the class of its first operand (a `where` is classed by
    its bool condition, as HLO's `select` is);
  * contractions (`mm`, `bmm`, `addmm`, `baddbmm`, ... — what `einsum`
    and `matmul` lower to) charge 2*M*N*K FLOPs, FLOPs/2 of them `fma`;
  * transcendentals expand per element into `TRANSCENDENTAL_EXPANSION`
    (4 `fma` + 1 `fdiv`), and the composite ops XLA sees decomposed
    (`silu`, `gelu`, `softmax`, ...) are charged through
    `COMPOSITE_EXPANSION`, a table of the HLO ops they lower to;
  * an operand that an elementwise op broadcasts up to its output (a
    scalar, or a smaller tensor) charges one `base` op per output
    element, the `broadcast` instruction HLO materialises for it; a
    select (`where`) read by more than one op is charged again, with its
    broadcasts, for each reader after the first (XLA fuses it into each
    consumer);
  * pure views charge nothing; ops that move data (index, gather,
    scatter, cat, copy, pad) and ops that fill a fresh tensor charge
    `base` at their output elements, as every non-F op does in the
    reference; a reduction charges its output elements;
  * XLA keeps arrays row-major, so an op reading a permuted view, or a
    contraction handed a tensor torch kept in a permuted layout, pays a
    transpose: two `base` ops an element (HLO's transpose and the copy
    that lays it out), once per tensor;
  * the HBM-traffic proxy models traffic across XLA:CPU's fusion
    boundaries, as `hlo._fusion_bytes` does: parameters and cache
    tensors are read once by each op that reads them (window-sized
    through an indexing op); one stacked over a segment the JAX model
    scans (more than one layer) is sliced out of the stack first, so
    that read counts three times (slice read, slice write, the op's
    read) and its elements are charged as `dynamic-slice` ops; a
    contraction's operands and result cross HBM twice each (written by
    the producer, read by the consumer: XLA:CPU fuses no elementwise op
    into a dot); reductions and data-movement ops read their operands,
    and data-movement ops write their result; a transpose reads and
    writes its tensor; writes into a cache count; elementwise
    intermediates count no bytes (XLA fuses them).  Then
    ``base += bytes / BYTES_PER_BASE_OP``, as in the reference.

The mixes are not XLA's bit for bit: XLA fuses, decomposes and lays out
differently from aten.  They are held to the JAX package's
`model_opcount` per isa group within 0.05 (`tests/test_torch_opcounts.py`),
with the same two hottest F groups, except where the two models run
different algorithms for the same function: the JAX RWKV6 prefill runs
its chunk-64 WKV form and the port's plain scan the per-step recurrence,
and the JAX RecurrentGemma prefill cuts local attention into two-chunk
pairs where the port makes one windowed call (ROADMAP §3 lists the
measured gaps).  `lowering` and the registry are exact given the same
`OpCount`.

`model_opcount` is an analysis of the model, as the JAX one is (that
one compiles the smoke step for the CPU backend): it runs the smoke
config on the CPU, on concrete tensors, with `use_kernel="plain"`.  A
hand-written kernel is launched through ctypes, which a dispatch-mode
counter cannot see, so counting on the card would silently drop
attention, the scans and the grouped FFN.  It takes no device argument
and is on no timed path; the simulations that consume its traces run
on the card.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import isa

__all__ = ["OpCount", "opcount_from_torch", "model_opcount", "PHASES",
           "MIX_BATCH", "MIX_SEQ_LEN", "F_OP_GROUP", "TRANSCENDENTALS",
           "TRANSCENDENTAL_EXPANSION", "I_OP_GROUP", "BYTES_PER_BASE_OP",
           "ATEN_TO_HLO", "COMPOSITE_EXPANSION"]

# ---------------------------------------------------------------------------
# HLO op -> isa-group mapping (the reference's maps)
# ---------------------------------------------------------------------------

# float-class elementwise ops with a direct RV32F counterpart group
F_OP_GROUP = {
    "add": "fadd", "subtract": "fadd",
    "reduce": "fadd", "reduce-window": "fadd",   # charged per input element
    "multiply": "fmul",
    "divide": "fdiv", "remainder": "fdiv",
    "sqrt": "fsqrt", "rsqrt": "fsqrt", "cbrt": "fsqrt",
    "compare": "fcmp", "select": "fcmp", "maximum": "fcmp",
    "minimum": "fcmp", "clamp": "fcmp", "abs": "fcmp", "negate": "fcmp",
    "sign": "fcmp", "is-finite": "fcmp",
    "convert": "fcvt", "floor": "fcvt", "ceil": "fcvt",
    "round-nearest-afz": "fcvt", "round-nearest-even": "fcvt",
}

# no RV32IMF instruction: expanded per element into a soft sequence
TRANSCENDENTALS = {
    "exponential", "exponential-minus-one", "log", "log-plus-one",
    "logistic", "tanh", "sine", "cosine", "tan", "atan2", "power",
    "erf", "erf-inv",
}
TRANSCENDENTAL_EXPANSION = {"fma": 4.0, "fdiv": 1.0}

# integer-class ops with an RV32M counterpart group
I_OP_GROUP = {"multiply": "mul", "divide": "div", "remainder": "rem"}

# HBM-traffic proxy -> base load/store ops: one RV32 word per 4 bytes
BYTES_PER_BASE_OP = 4.0

# ---------------------------------------------------------------------------
# aten op -> HLO op
# ---------------------------------------------------------------------------

# elementwise aten ops (in-place forms share the name without "_") and
# the HLO op each lowers to
ATEN_TO_HLO = {
    "add": "add", "sub": "subtract", "rsub": "subtract",
    "mul": "multiply", "div": "divide", "remainder": "remainder",
    "fmod": "remainder", "floor_divide": "divide",
    "sqrt": "sqrt", "rsqrt": "rsqrt",
    "exp": "exponential", "expm1": "exponential-minus-one",
    "log": "log", "log1p": "log-plus-one",
    "tanh": "tanh", "sin": "sine", "cos": "cosine", "tan": "tan",
    "atan2": "atan2", "pow": "power", "square": "multiply", "erf": "erf",
    "erfinv": "erf-inv",
    "maximum": "maximum", "minimum": "minimum", "clamp": "clamp",
    "clamp_min": "maximum", "clamp_max": "minimum",
    "abs": "abs", "neg": "negate", "sign": "sign", "isfinite": "is-finite",
    "floor": "floor", "ceil": "ceil", "round": "round-nearest-even",
    "lt": "compare", "le": "compare", "gt": "compare", "ge": "compare",
    "eq": "compare", "ne": "compare",
    "where": "select", "masked_fill": "select",
    "logical_and": "and", "logical_or": "or", "logical_not": "not",
    "bitwise_and": "and", "bitwise_or": "or", "bitwise_not": "not",
    "bitwise_xor": "xor",
    "_to_copy": "convert",
}

# reductions: charged at their output elements under the op XLA's reduce
# computation applies
REDUCTIONS = {"sum": "add", "mean": "add", "amax": "maximum",
              "amin": "minimum", "max": "maximum", "min": "minimum",
              "prod": "multiply", "argmax": "compare", "argmin": "compare",
              "cumsum": "add", "cumprod": "multiply", "any": "or",
              "all": "and"}

# composite ops one aten op carries that XLA sees decomposed: charged
# per output element as the HLO ops they lower to (silu = x * logistic(x)
# as XLA:CPU expands logistic: negate, exp, add, divide; gelu's tanh form
# = 0.5 x (1 + tanh(c (x + 0.044715 x^3))); softmax = a max, a subtract,
# an exp, a sum and a divide)
COMPOSITE_EXPANSION = {
    "silu": {"negate": 1, "exponential": 1, "add": 1, "divide": 1,
             "multiply": 1},
    "gelu": {"multiply": 5, "add": 2, "tanh": 1},
    "sigmoid": {"negate": 1, "exponential": 1, "add": 1, "divide": 1},
    "_softmax": {"maximum": 1, "subtract": 1, "exponential": 1, "add": 1,
                 "divide": 1},
    "_log_softmax": {"maximum": 1, "subtract": 2, "exponential": 1,
                     "add": 1, "log": 1},
    "softplus": {"exponential": 1, "log-plus-one": 1},
    "elu": {"exponential-minus-one": 1, "select": 1},
    "relu": {"maximum": 1},
    "lerp": {"subtract": 1, "multiply": 1, "add": 1},
    "addcmul": {"multiply": 2, "add": 1},
    "addcdiv": {"divide": 1, "multiply": 1, "add": 1},
}

# contractions: 2*M*N*K FLOPs; `add*` forms also add their input
CONTRACTIONS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "dot",
                "addmv", "convolution", "_convolution"}

# ops that move or fill data: base at their output elements
DATA_MOVEMENT = {"index", "gather", "scatter", "scatter_add", "index_put",
                 "_index_put_impl", "index_select", "index_add",
                 "index_copy", "embedding", "cat", "stack", "copy",
                 "clone", "constant_pad_nd", "pad", "repeat",
                 "repeat_interleave", "flip", "roll", "tril", "triu",
                 "sort", "topk", "one_hot", "masked_scatter",
                 "masked_select", "nonzero", "_unsafe_index",
                 "slice_scatter", "select_scatter", "full", "full_like",
                 "zeros", "zeros_like", "ones", "ones_like", "fill",
                 "new_zeros", "new_ones", "new_full", "empty_like",
                 "scalar_tensor", "lift_fresh_copy", "contiguous",
                 "_reshape_copy", "view_copy", "expand_copy",
                 "permute_copy", "transpose_copy"}
# of those, the ones whose parameter/cache operand is read window-sized
_INDEXING = {"index", "gather", "index_select", "embedding", "_unsafe_index"}
# never charged: fresh buffers with no values yet, index ranges (HLO's
# iota and constants are plumbing) and host reads
_FREE = {"empty", "empty_strided", "new_empty", "new_empty_strided",
         "arange", "linspace", "_local_scalar_dense", "item", "is_nonzero",
         "equal", "allclose", "resize_", "set_", "detach", "alias",
         "lift_fresh", "_has_compatible_shallow_copy_type", "result_type",
         "randn", "normal", "uniform", "random", "bernoulli", "rand"}


@dataclass
class OpCount:
    """Executed-op counts over the isa group alphabet (FlopCount idiom).

    `counts` maps isa group name -> dynamic op count; `flops`, `bytes` and
    `transcendental_elems` keep the raw accounting the mapping consumed,
    so serialized tables stay auditable against the op walk.
    """

    counts: dict = field(default_factory=dict)
    flops: float = 0.0
    bytes: float = 0.0
    transcendental_elems: float = 0.0

    def __add__(self, other: "OpCount") -> "OpCount":
        if not isinstance(other, OpCount):
            return NotImplemented
        merged = dict(self.counts)
        for g, v in other.counts.items():
            merged[g] = merged.get(g, 0.0) + v
        return OpCount(merged, self.flops + other.flops,
                       self.bytes + other.bytes,
                       self.transcendental_elems
                       + other.transcendental_elems)

    def __mul__(self, k: float) -> "OpCount":
        return OpCount({g: v * k for g, v in self.counts.items()},
                       self.flops * k, self.bytes * k,
                       self.transcendental_elems * k)

    __rmul__ = __mul__

    def total(self) -> float:
        return float(sum(self.counts.values()))

    def frac(self) -> np.ndarray:
        """(NUM_GROUPS,) stationary fractions — `repro_torch.core.traces.Mix`
        layout, consumable by `paint_trace` / `analytic_cpi`."""
        v = np.zeros(isa.NUM_GROUPS)
        for g, c in self.counts.items():
            v[isa.GROUP_ID[g]] = c
        s = v.sum()
        if s <= 0:
            raise ValueError("OpCount has no executed ops to normalise")
        return v / s

    def to_dict(self) -> dict:
        return {"counts": dict(self.counts), "flops": self.flops,
                "bytes": self.bytes,
                "transcendental_elems": self.transcendental_elems}

    @classmethod
    def from_dict(cls, d: dict) -> "OpCount":
        return cls(dict(d["counts"]), float(d["flops"]), float(d["bytes"]),
                   float(d.get("transcendental_elems", 0.0)))


# ---------------------------------------------------------------------------
# the dispatch-mode counter
# ---------------------------------------------------------------------------

def _tensors(x) -> list:
    """The tensors of a (nested) list, tuple or dict."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _cls(dtype: torch.dtype) -> str:
    """'f' for float/complex, 'i' for integer/bool (`hlo._dtype_class`)."""
    return "f" if (dtype.is_floating_point or dtype.is_complex) else "i"


def _out_of_order(t: torch.Tensor) -> bool:
    """Dims not in row-major order (and no broadcast dims)."""
    if t.dim() < 2 or 0 in t.stride():
        return False
    st = [s for s, n in zip(t.stride(), t.shape) if n > 1]
    return any(a < b for a, b in zip(st, st[1:]))


def _permuted(t: torch.Tensor) -> bool:
    """A view whose dims are not in row-major order."""
    return t._is_view() and _out_of_order(t)


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


# the traffic proxy's multipliers (see the module docstring)
SCAN_SLICE_READS = 3       # slice read + slice write + the op's read
UNFUSED_CROSSINGS = 2      # written by the producer, read by the consumer
TRANSPOSE_OPS = 2          # HLO's transpose and the copy that lays it out

_VIEWS = {"view", "_unsafe_view", "reshape", "expand", "slice", "select",
          "t", "transpose", "permute", "unsqueeze", "squeeze", "as_strided",
          "unbind", "split", "split_with_sizes", "chunk", "narrow", "unfold",
          "diagonal", "view_as", "expand_as", "_reshape_alias"}


class opcount_from_torch(TorchDispatchMode):
    """Charge the aten ops run under it to isa groups (the rules are the
    module docstring's); `opcount()` gives the `OpCount`.

    `resident` is the tensors HBM holds across the step (the parameters,
    and the cache at decode): reads of them, and writes into them, count
    toward the traffic proxy.  `scanned` is those of them stacked over a
    segment the JAX model scans (more than one layer).  Use it as a
    context manager around the model's step.
    """

    def __init__(self, resident=(), scanned=()):
        super().__init__()
        self._resident = {_storage(t) for t in _tensors(resident)
                          if t.numel()}
        self._scanned = {_storage(t) for t in _tensors(scanned)
                         if t.numel()}
        self.hist: dict[str, float] = {}
        self.bytes = 0.0
        # id -> tensor (kept alive, so an id is never reused): the
        # tensors already transposed, and each select's result with its
        # cost and readers so far
        self._transposed: dict[int, torch.Tensor] = {}
        self._selects: dict[int, tuple] = {}

    def _acc(self, op: str, cls: str, n: float) -> None:
        if n:
            key = f"{op}:{cls}"
            self.hist[key] = self.hist.get(key, 0.0) + float(n)

    def _is_resident(self, t) -> bool:
        return t.numel() > 0 and _storage(t) in self._resident

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._charge(func, args, kwargs, out)
        return out

    def _charge(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        inplace = name.endswith("_") and not name.startswith("_")
        base = name[:-1] if inplace else name
        outs = _tensors(out)
        if base in _FREE or not outs or func.is_view or base in _VIEWS:
            return
        res = outs[0]
        n_out = float(res.numel())
        ins = _tensors(list(args) + list(kwargs.values()))
        target = args[0] if (inplace or base in ("copy", "index_put",
                                                 "_index_put_impl")) \
            else None
        contraction = base in CONTRACTIONS
        self._recompute_selects(ins)
        self._traffic(base, ins, res, target, contraction)
        self._transposes(ins, contraction)
        if contraction:
            k = (args[1] if base in ("addmm", "baddbmm", "addbmm", "addmv")
                 else args[0]).shape[-1]
            self._acc("dot", "f", 2.0 * n_out * k)
            if base.startswith("add"):
                self._acc("add", _cls(res.dtype), n_out)
        elif base in COMPOSITE_EXPANSION:
            for op, k in COMPOSITE_EXPANSION[base].items():
                self._acc(op, _cls(res.dtype), n_out * k)
            self._broadcasts(ins, args, n_out)
        elif base == "var":
            n_in = float(ins[0].numel())
            self._acc("subtract", "f", n_in)
            self._acc("multiply", "f", n_in)
            self._acc("add", "f", n_out)
            self._acc("divide", "f", n_out)
        elif base in REDUCTIONS:
            self._acc(REDUCTIONS[base], _cls(ins[0].dtype), n_out)
            if base == "mean":
                self._acc("divide", _cls(res.dtype), n_out)
        elif base in ATEN_TO_HLO:
            op = ATEN_TO_HLO[base]
            if op == "convert" and ins and ins[0].dtype == res.dtype:
                op = "copy"
            square = op == "power" and len(args) > 1 and args[1] == 2
            if square:
                op = "multiply"                      # x**2 is x*x in HLO
            cls = _cls(ins[0].dtype if op in ("compare", "select") and ins
                       else res.dtype)
            before = dict(self.hist)
            self._acc(op, cls, n_out)
            if not square:
                self._broadcasts(ins, args, n_out)
            if op == "select":
                cost = {k: v - before.get(k, 0.0)
                        for k, v in self.hist.items()
                        if v != before.get(k, 0.0)}
                self._selects[id(res)] = (res, cost, 0)
        else:
            # data movement, fills and anything unmapped: base
            self._acc(base, _cls(res.dtype), n_out)

    def _recompute_selects(self, ins) -> None:
        """XLA fuses a select (with its broadcasts) into each consumer:
        every reader after the first recomputes it."""
        for t in ins:
            hit = self._selects.get(id(t))
            if hit is not None and hit[0] is t:
                ref, cost, readers = hit
                if readers:
                    for key, n in cost.items():
                        self.hist[key] = self.hist.get(key, 0.0) + n
                self._selects[id(t)] = (ref, cost, readers + 1)

    def _traffic(self, base, ins, res, target, contraction) -> None:
        """The HBM-traffic proxy (bytes) of one op."""
        seen: set[int] = set()
        for t in ins:
            if self._is_resident(t):
                if t is target or id(t) in seen:
                    continue
                seen.add(id(t))
                nb = _nbytes(t)
                if base in _INDEXING:          # window-sized read
                    nb = min(nb, res.numel() * t.element_size())
                if _storage(t) in self._scanned:
                    nb *= SCAN_SLICE_READS
                    self._acc("dynamic-slice", _cls(t.dtype), t.numel())
                self.bytes += nb
            elif contraction:
                self.bytes += UNFUSED_CROSSINGS * _nbytes(t)
            elif base in REDUCTIONS or base == "var" or \
                    base in DATA_MOVEMENT:
                self.bytes += _nbytes(t)
        if contraction:
            self.bytes += UNFUSED_CROSSINGS * _nbytes(res)
        elif base in DATA_MOVEMENT:
            self.bytes += _nbytes(res)
        if target is not None and self._is_resident(target):
            written = [t for t in ins if t is not target
                       and t.dtype == target.dtype]
            self.bytes += max((_nbytes(t) for t in written),
                              default=_nbytes(target))

    def _transposes(self, ins, contraction) -> None:
        """XLA keeps arrays row-major: reading a permuted view, or handing
        a contraction a tensor torch kept permuted, is a transpose (two
        base ops an element, read and written), once per tensor."""
        for t in ins:
            src = t._base if contraction and t._is_view() else t
            hit = _out_of_order(src) if contraction else _permuted(t)
            if hit and self._transposed.get(id(src)) is not src:
                self._transposed[id(src)] = src
                self._acc("transpose", _cls(src.dtype),
                          TRANSPOSE_OPS * src.numel())
                self.bytes += 2 * _nbytes(src)

    def _broadcasts(self, ins, args, n_out) -> None:
        """One broadcast (base) per output element for each operand that
        is broadcast up to the output: Python scalars and smaller
        tensors."""
        for t in ins:
            if t.numel() < n_out:
                self._acc("broadcast", _cls(t.dtype), n_out)
        for a in args[1:]:
            if isinstance(a, (int, float)) and not isinstance(a, bool):
                self._acc("broadcast", "f" if isinstance(a, float)
                          else "i", n_out)

    def opcount(self) -> OpCount:
        """The histogram charged to isa groups, as `opcount_from_hlo`
        charges HLO's."""
        counts: dict[str, float] = {g: 0.0 for g in isa.GROUP_NAMES}
        trans = 0.0
        for key, n in self.hist.items():
            op, cls = key.rsplit(":", 1)
            if op == "dot":
                counts["fma"] += n / 2.0       # n carries FLOPs for dot ops
            elif cls == "f" and op in TRANSCENDENTALS:
                trans += n
                for g, k in TRANSCENDENTAL_EXPANSION.items():
                    counts[g] += n * k
            elif cls == "f" and op in F_OP_GROUP:
                counts[F_OP_GROUP[op]] += n
            elif cls == "i" and op in I_OP_GROUP:
                counts[I_OP_GROUP[op]] += n
            else:
                counts["base"] += n
        counts["base"] += self.bytes / BYTES_PER_BASE_OP
        counts = {g: v for g, v in counts.items() if v > 0}
        flops = sum(n for key, n in self.hist.items() if key == "dot:f"
                    or (key.endswith(":f") and key.rsplit(":", 1)[0] in
                        F_OP_GROUP.keys() | TRANSCENDENTALS))
        return OpCount(counts, flops=float(flops), bytes=float(self.bytes),
                       transcendental_elems=trans)


# ---------------------------------------------------------------------------
# model-zoo lowering: config -> counted phase step -> OpCount
# ---------------------------------------------------------------------------

PHASES = ("prefill", "decode")

# the reference's: small enough to compile in ~1s on CPU, large enough
# that per-token terms dominate per-call constants
MIX_BATCH = 2
MIX_SEQ_LEN = 64

_CACHE: dict[tuple[str, str], OpCount] = {}


def _batch(cfg, phase: str, seed: int) -> dict:
    """The phase's inputs at `_abstract_batch`'s shapes, drawn from
    `seed`: tokens (or embeds where `not cfg.embed_inputs`), (B, T, 3)
    positions for mrope; at decode one token and (B,) positions."""
    rng = np.random.default_rng(seed)
    b, t = MIX_BATCH, MIX_SEQ_LEN
    out: dict = {}
    width = t if phase == "prefill" else 1
    if cfg.embed_inputs:
        out["tokens"] = torch.from_numpy(
            rng.integers(0, cfg.vocab, (b, width)).astype(np.int32))
    else:
        out["embeds"] = torch.from_numpy(rng.standard_normal(
            (b, width, cfg.d_model)).astype(np.float32)).to(cfg.torch_dtype)
    if phase == "prefill":
        if cfg.pos == "mrope":
            pos = np.broadcast_to(np.arange(t, dtype=np.int32)[None, :, None],
                                  (b, t, 3))
            out["positions"] = torch.from_numpy(np.ascontiguousarray(pos))
    else:
        out["positions"] = torch.from_numpy(
            rng.integers(t // 2, t, (b,)).astype(np.int32))
    return out


def _scanned(cfg, tree) -> list:
    """The leaves of `tree` (params or cache) stacked over a segment of
    more than one layer: the JAX model scans those, and XLA slices each
    layer out of the stack before using it."""
    from repro_torch.models import transformer

    segs = tree["segments"] if isinstance(tree, dict) else tree
    return [seg for seg, (_, n) in zip(segs, transformer.segments(cfg))
            if n > 1]


def count_phase(arch: str, phase: str, weight_seed: int = 0,
                token_seed: int = 0) -> OpCount:
    """Count one (smoke config, phase) cell on the CPU (uncached): weights
    from `numpy_params(cfg, weight_seed)`, inputs from `token_seed`.
    Decode counts only `decode_step`, against the cache a prefill of
    `MIX_SEQ_LEN` tokens filled.  The decode MoE's grouped FFN is charged
    at capacity, every expert, as the JAX model's three einsums run
    (`moe_gmm_skip` skips the empty experts, which would make the count
    depend on the routing): the output is the same, since an empty
    expert's zero rows give zeros."""
    from repro_torch.configs import base as cb
    from repro_torch.kernels import moe_gmm
    from repro_torch.models import convert, transformer

    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    cb.load_all()
    cfg = cb.get_config(arch).smoke()
    params = convert.params_from_numpy(convert.numpy_params(cfg, weight_seed),
                                       "cpu", cfg.torch_dtype)
    skip_plain = moe_gmm.moe_gmm_skip_plain

    def at_capacity(x, wg, wi, wo, counts, *, gated=True):
        return moe_gmm.moe_gmm_plain(x, wg, wi, wo, gated=gated)

    with torch.no_grad():
        pre = _batch(cfg, "prefill", token_seed)
        # uncounted: fills the layers' caches of host constants (RoPE
        # frequencies, M-RoPE band maps), which copy to the device once
        _, cache, _ = transformer.prefill(cfg, params, pre,
                                          use_kernel="plain")
        if phase == "prefill":
            with opcount_from_torch(resident=params,
                                    scanned=_scanned(cfg, params)) as counter:
                transformer.prefill(cfg, params, pre, use_kernel="plain")
            return counter.opcount()
        dec = _batch(cfg, "decode", token_seed)
        moe_gmm.moe_gmm_skip_plain = at_capacity
        try:
            with opcount_from_torch(
                    resident=[params, cache],
                    scanned=[_scanned(cfg, params), _scanned(cfg, cache)]
            ) as counter:
                transformer.decode_step(cfg, params, dec, cache,
                                        use_kernel="plain")
        finally:
            moe_gmm.moe_gmm_skip_plain = skip_plain
        return counter.opcount()


def model_opcount(arch: str, phase: str) -> OpCount:
    """Per-phase instruction-mix accounting for one model-zoo config.

    Runs the smoke config's phase step on the CPU under
    `opcount_from_torch` (plain kernels: see the module docstring) and
    charges the counted ops to isa groups.  There is no device argument:
    this is an analysis of the model, not a path that runs on the card.
    Cached per (arch, phase): the counts do not depend on the weights or
    the tokens.
    """
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    key = (arch, phase)
    if key not in _CACHE:
        _CACHE[key] = count_phase(arch, phase)
    return _CACHE[key]
