"""FLOPs, bytes and ops of an eager step, counted as they dispatch, and
its roofline terms: the port's counterpart of `repro.analysis.hlo`.

The JAX package walks XLA's optimized HLO (`analyze_module`, with `while`
trip counts applied).  Eager PyTorch has no HLO, so `CostCounter`, a
`TorchDispatchMode`, counts the aten ops as they run:

  * views, fresh buffers, index ranges and 0-d constants count nothing
    (HLO's bitcasts, iotas and constants are plumbing there);
  * a contraction (`mm`, `bmm`, `addmm`, ...: what `matmul` and `einsum`
    lower to) counts 2*M*N*K FLOPs, as `hlo._dot_flops`, and its `add*`
    forms one more per output element;
  * every other op counts one FLOP per output element, as HLO's
    elementwise and data-moving instructions do;
  * FLOPs are summed by dtype class (`dtype_class`): "bf16" (bf16/f16,
    the tensor cores' rate), "f32" (f32/f64) and "int" (integers and
    bool), classed by the op's result, or by its first float input where
    a float op gives an integer or bool result (a comparison, argmax);
  * bytes: each tensor an op reads counted once at its footprint (a
    broadcast dimension once), each result written once (`_nbytes` of
    `workloads.opcounts`, without its fusion model: eager ops do not
    fuse); an op that overwrites its target (`copy_`, `fill_`, `zero_`)
    does not read it, and an in-place scatter (`index_put_`, ...) writes
    its update, not the whole target;
  * `ops` counts the ops charged.

Each hand-written kernel is charged once, by `kernel(name, work)` around
its launch: `work` is the count of the formula beside the kernel (each
kernel module's `cost`, the count its bound in PERF.md uses), whichever
route runs: the kernel on the card, or, under a counter on the CPU or the
meta device, a stand-in that gives the plain body's result (empty
tensors on meta).  The ops inside are not counted on top, so a count does
not depend on the route.  Under autograd the kernels on a training path
take the card's route on every device (`kernels.common.route`): the
forward charged as the kernel, the backward the plain body re-run and
differentiated (`KernelVjp`), counted op by op as on the card.

A counter given `device` counts only the ops whose result lies on that
device type: `torch.utils.checkpoint` saves and restores the card's RNG
state through host tensors, which a step on the meta device does not.
A kernel whose work depends on values (decode attention's `kv_len`,
`moe_gmm_skip`'s live experts) is charged its fixed-shape count (the
whole cache, every expert): a meta tensor has no values, and a count
reads none on any device.

`roofline_terms` is the reference's, with the H100's constants and a
compute term summed over the dtype classes.  What `hlo` also does has no
counterpart here: the HLO text parser, `op_histogram` (the port's op mix
is `workloads.opcounts`), `xla_cost_analysis` and the collectives (one
card has none).
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CostCounter", "kernel", "uncounted", "counting", "replay",
           "combine", "dtype_class", "work", "roofline_terms",
           "CLASSES", "H100_PEAK", "H100_HBM_BW", "H100_LINK_BW",
           "H100_HBM_BYTES"]

CLASSES = ("bf16", "f32", "int")
# the H100 SXM's peak rates (NVIDIA's data sheet, as the on-chip guide
# tabulates them): bf16 dense tensor cores, f32 on the CUDA cores, and
# int32 as 132 SMs x 64 lanes x the 1,980 MHz boost clock
H100_PEAK = {"bf16": 989e12, "f32": 67e12, "int": 132 * 64 * 1.98e9}
H100_HBM_BW = 3.35e12
H100_LINK_BW = 450e9          # NVLink 4, one direction
H100_HBM_BYTES = 80 * 1024 ** 3

# views: no data moves (HLO's bitcasts)
_VIEWS = {"view", "_unsafe_view", "reshape", "expand", "slice", "select",
          "t", "transpose", "permute", "unsqueeze", "squeeze", "as_strided",
          "unbind", "split", "split_with_sizes", "chunk", "narrow", "unfold",
          "diagonal", "view_as", "expand_as", "_reshape_alias", "alias",
          "detach", "lift_fresh"}
# fresh buffers with no values, index ranges and constants (HLO's
# iotas and constants), host reads and draws
_FREE = {"empty", "empty_strided", "new_empty", "new_empty_strided",
         "empty_like", "arange", "linspace", "scalar_tensor",
         "_local_scalar_dense", "item",
         "is_nonzero", "equal", "resize_", "set_", "result_type",
         "_has_compatible_shallow_copy_type", "randn", "normal", "uniform",
         "random", "bernoulli", "rand", "randint"}
CONTRACTIONS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "dot",
                "addmv", "convolution", "_convolution"}
# ops that overwrite their first argument without reading it
_OVERWRITE = {"copy_", "fill_", "zero_"}
# in-place scatters: (the update's argument index) — they write the
# update, not the whole target
_SCATTER = {"index_put_": 2, "_index_put_impl_": 2, "index_add_": 3,
            "index_copy_": 3, "scatter_": 3, "scatter_add_": 3,
            "scatter_reduce_": 3, "masked_scatter_": 2}

_ACTIVE: list["CostCounter"] = []


def dtype_class(dtype: torch.dtype) -> str:
    """"bf16" (bf16/f16), "f32" (other floats) or "int" (integers, bool)."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype.is_floating_point or dtype.is_complex:
        return "f32"
    return "int"


def work(flops: int, cls: str, nbytes: int) -> dict:
    """A kernel's count: {"flops": {cls: flops}, "bytes": nbytes}."""
    return {"flops": {cls: int(flops)}, "bytes": int(nbytes)}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of `t`'s footprint: a broadcast (stride-0) dimension once."""
    if not t.numel():
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def counting() -> "CostCounter | None":
    """The innermost active counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def uncounted():
    """Count none of the ops run inside (e.g. a constant a model makes
    once and caches: HLO's constants are plumbing)."""
    counters = list(_ACTIVE)
    for c in counters:
        c._muted += 1
    try:
        yield counters
    finally:
        for c in counters:
            c._muted -= 1


@contextlib.contextmanager
def kernel(name: str, count):
    """Charge kernel `name` once to every active counter, `count()` (the
    kernel's `work` dict, called only under a counter), and count none of
    the ops run inside."""
    with uncounted() as counters:
        if counters:
            w = count()
            for c in counters:
                c._charge_kernel(name, w)
        yield


# recorded counts of calls on the meta device: {(counter's settings,
# key): what the call added to the counter}
_REPLAYS: dict = {}


def replay(key, run):
    """`run()` under the one active counter, on meta tensors, once per
    `key` (a hashable description of the call: its function and the
    shapes, strides, dtypes and flags of its arguments); later calls with
    the same key add what the first added to the counter and return meta
    tensors laid out as the first call's results (a tuple of tensors and
    Nones), without running.  A call on meta tensors depends on nothing
    but its key, so its count is the first one's.  Used for the kernels'
    plain backwards, which the layers of a model repeat at the same
    shapes."""
    if len(_ACTIVE) != 1:
        return run()
    c = _ACTIVE[0]
    full = (c.device, key)
    if full in _REPLAYS:
        added, layout = _REPLAYS[full]
        c._absorb(added)
        return tuple(None if t is None else torch.empty_strided(
            t[0], t[1], dtype=t[2], device="meta") for t in layout)
    before = c.result()
    out = run()
    _REPLAYS[full] = (combine(c.result(), before, -1), tuple(
        None if t is None else (t.shape, t.stride(), t.dtype) for t in out))
    return out


def _zero(v):
    return {k: _zero(x) for k, x in v.items()} if isinstance(v, dict) else 0


def combine(a, b, k: int = 1):
    """a + k b, key by key, over nested dicts of ints (`CostCounter.result`
    dicts; a key one side lacks counts 0 there)."""
    if isinstance(a, dict) or isinstance(b, dict):
        a = a if isinstance(a, dict) else _zero(b)
        b = b if isinstance(b, dict) else _zero(a)
        return {key: combine(a.get(key, 0), b.get(key, 0), k)
                for key in {**a, **b}}
    return a + k * b


class CostCounter(TorchDispatchMode):
    """Count the FLOPs (by dtype class), bytes and ops of the aten ops
    run under it (the module docstring's rules).  Use it as a context
    manager around a step; `result()` gives the totals, each kernel's
    share and each aten op's, as ints."""

    def __init__(self, device: str | None = None):
        super().__init__()
        self.device = None if device is None else torch.device(device).type
        self.flops = dict.fromkeys(CLASSES, 0)
        self.bytes_read = 0
        self.bytes_written = 0
        self.kernel_bytes = 0
        self.ops = 0
        self.kernels: dict[str, dict] = {}
        self.by_op: dict[str, dict] = {}
        self._muted = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    @property
    def bytes(self) -> int:
        """Bytes read and written by the aten ops, and the kernels'."""
        return self.bytes_read + self.bytes_written + self.kernel_bytes

    def _add(self, key: str, table: dict, flops: dict, nbytes: int):
        row = table.setdefault(key, {"calls": 0, "flops": dict.fromkeys(
            CLASSES, 0), "bytes": 0})
        row["calls"] += 1
        for cls, n in flops.items():
            row["flops"][cls] += n
            self.flops[cls] += n
        row["bytes"] += nbytes
        self.ops += 1

    def _charge_kernel(self, name: str, w: dict) -> None:
        self.kernel_bytes += w["bytes"]
        self._add(name, self.kernels, w["flops"], w["bytes"])

    def _absorb(self, d: dict) -> None:
        """Add a `result()`-shaped difference (`replay`)."""
        for cls, n in d["flops"].items():
            self.flops[cls] += n
        self.bytes_read += d["bytes_read"]
        self.bytes_written += d["bytes_written"]
        self.kernel_bytes += d["kernel_bytes"]
        self.ops += d["ops"]
        for table, rows in ((self.kernels, d["kernels"]),
                            (self.by_op, d["by_op"])):
            for key, row in rows.items():
                table[key] = combine(table.get(key, 0), row)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._muted:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        base = name[:-1] if name.endswith("_") and not \
            name.startswith("_") else name
        outs = _tensors(out)
        if (func.is_view or not outs or base in _VIEWS or base in _FREE
                or name in _FREE):
            return
        res = outs[0]
        if self.device is not None and res.device.type != self.device:
            return
        ins = _tensors(list(args) + list(kwargs.values()))
        n_out = res.numel()
        if base in CONTRACTIONS:
            if base.startswith("add"):
                k = args[1].shape[-1]
            elif "convolution" in base:
                k = args[1][0].numel()
            else:
                k = args[0].shape[-1]
            flops = 2 * n_out * k + (n_out if base.startswith("add") else 0)
        else:
            flops = n_out
        cls = dtype_class(res.dtype)
        if cls == "int":
            floats = [t for t in ins if t.dtype.is_floating_point]
            if floats:
                cls = dtype_class(floats[0].dtype)
        target = args[0] if name in _OVERWRITE or name in _SCATTER else None
        seen, read = set(), 0
        for t in ins:
            if t is target or id(t) in seen:
                continue
            seen.add(id(t))
            read += _nbytes(t)
        if name in _SCATTER:
            upd = args[_SCATTER[name]]
            written = sum(_nbytes(t) for t in _tensors(upd)
                          if t.dtype == res.dtype) or _nbytes(res)
        else:
            written = sum(_nbytes(t) for t in {id(t): t for t in outs}
                          .values())
        self.bytes_read += read
        self.bytes_written += written
        self._add(name, self.by_op, {cls: flops}, read + written)

    def result(self) -> dict:
        """{"flops": {class: n}, "flops_total", "bytes", "bytes_read",
        "bytes_written", "kernel_bytes", "ops", "kernels": {name:
        {"calls", "flops", "bytes"}}, "by_op": {aten op: the same}}."""
        return {"flops": dict(self.flops),
                "flops_total": sum(self.flops.values()),
                "bytes": self.bytes, "bytes_read": self.bytes_read,
                "bytes_written": self.bytes_written,
                "kernel_bytes": self.kernel_bytes, "ops": self.ops,
                "kernels": {k: dict(v, flops=dict(v["flops"]))
                            for k, v in self.kernels.items()},
                "by_op": {k: dict(v, flops=dict(v["flops"]))
                          for k, v in self.by_op.items()}}


def roofline_terms(flops, hbm_bytes: float, coll_bytes: float = 0.0, *,
                   peak_flops=H100_PEAK, hbm_bw: float = H100_HBM_BW,
                   link_bw: float = H100_LINK_BW) -> dict:
    """Terms in seconds, all per device: the reference's
    `hlo.roofline_terms` with the H100's constants.  `flops` is a number
    or {dtype class: FLOPs}; `peak_flops` a number or {class: FLOP/s}.
    The compute term is the sum over the classes of each class's FLOPs
    over its peak.  One card moves no collective bytes."""
    parts = flops if isinstance(flops, dict) else {None: flops}
    compute = sum(
        n / (peak_flops[cls] if isinstance(peak_flops, dict) else
             peak_flops) for cls, n in parts.items())
    memory = hbm_bytes / hbm_bw
    collective = coll_bytes / link_bw
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
    }
