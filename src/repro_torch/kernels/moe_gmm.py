"""Grouped expert FFN: Hopper kernel and its plain versions.

PyTorch port of the JAX package's Pallas kernels
`repro.kernels.moe_gmm.moe_gmm` and `moe_gmm_skip`: for each expert e of
x (E, C, D) (its capacity buffer), wg/wi (E, D, F) and wo (E, F, D),

    out[e] = (silu(x[e] @ wg[e]) * (x[e] @ wi[e])) @ wo[e]     (gated)
    out[e] = gelu_tanh(x[e] @ wg[e]) @ wo[e]                   (ungated)

with f32 accumulation, `h` rounded to x's dtype between the two stages as
the Pallas kernel's `h_ref` is, and the output in x's dtype.  The ungated
form reads `wg`, as the Pallas kernel does (the model's ungated FFN passes
its `wi` there).  `moe_gmm_skip` takes `counts` (E,) int32: experts with
`counts[e] <= 0` give exact zeros and read no weights.

* `moe_gmm_plain` / `moe_gmm_skip_plain`: one expert at a time (so the
  f32 copies of one expert's weights are all that is held at once), any
  device.
* the CUDA kernel `csrc/moe_gmm.cu` for `sm_90a` (bf16/f32, any C, D, F):
  two launches, each work item a column tile of one expert holding all
  of the expert's rows.  Two routes, chosen in its C entry point from
  the dtype, the shapes and the alignment alone: "mma" (bf16 with D and
  F multiples of 8 and 16-byte aligned operands, as on every model path:
  128-column items whose bf16 weight tiles stream through a cp.async
  ring in shared memory into `mma.sync` on the tensor cores) and "fma"
  (f32, or bf16 rows that are not 16-byte aligned: 64-column tiles, f32
  FMAs on the CUDA cores).  Built with `nvcc` at first use, bound with
  ctypes.

`moe_gmm` and `moe_gmm_skip` own the choice: CUDA tensors launch the
kernel (and count it in the wrapper's `.launches`, and the route it took
in `.routes`, e.g. `moe_gmm.routes == {"mma": 16, "fma": 0}`) or raise,
CPU tensors run the plain version; `use_kernel="plain"` forces the plain
version anywhere.  Where autograd records, `moe_gmm` (on every training
path of a MoE arch) takes the plain version's vector-Jacobian product as
its backward (`common.KernelVjp`, counted in
`moe_gmm.backward_recomputes`); `moe_gmm_skip` (decode only) raises.  The
Pallas kernels' block sizes are TPU tiling knobs with no counterpart
here.  `cost` is the kernels' count for a cost counter (`analysis.cost`)
and their bound.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from repro_torch.analysis import cost as _cost
from repro_torch.kernels import common

__all__ = ["moe_gmm", "moe_gmm_skip", "moe_gmm_plain", "moe_gmm_skip_plain",
           "build", "cost"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "moe_gmm.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _expert_plain(x, wg, wi, wo, gated: bool) -> torch.Tensor:
    """One expert: x (C, D) through wg/wi (D, F), wo (F, D)."""
    xf = x.float()
    hg = xf @ wg.float()
    if gated:
        h = F.silu(hg) * (xf @ wi.float())
    else:
        h = F.gelu(hg, approximate="tanh")   # jax.nn.gelu's default
    h = h.to(x.dtype).float()
    return (h @ wo.float()).to(x.dtype)


def moe_gmm_plain(x, wg, wi, wo, *, gated: bool = True) -> torch.Tensor:
    """x: (E, C, D); wg/wi: (E, D, F); wo: (E, F, D) -> (E, C, D)."""
    out = torch.empty_like(x)
    for e in range(x.shape[0]):
        out[e] = _expert_plain(x[e], wg[e], wi[e] if gated else None, wo[e],
                               gated)
    return out


def moe_gmm_skip_plain(x, wg, wi, wo, counts, *,
                       gated: bool = True) -> torch.Tensor:
    """`moe_gmm_plain` over the experts with counts[e] > 0; zeros for the
    others."""
    out = torch.zeros_like(x)
    for e, live in enumerate((counts > 0).tolist()):
        if live:
            out[e] = _expert_plain(x[e], wg[e], wi[e] if gated else None,
                                   wo[e], gated)
    return out


def cost(live: int, e: int, c: int, d: int, f: int, dtype: torch.dtype,
         *, gated: bool = True, counts: bool = False) -> dict:
    """The kernels' count (`analysis.cost.work`) with `live` of the `e`
    experts live (all of them for `moe_gmm`): 2 C D F FLOPs a weight
    matrix of a live expert (3 gated, 2 ungated) in `dtype`'s class; the
    live experts' weights and rows read once, the whole output written
    once, and the int32 counts read."""
    elem = torch.empty((), dtype=dtype).element_size()
    mats = 3 if gated else 2
    return _cost.work(
        2 * mats * live * c * d * f, _cost.dtype_class(dtype),
        elem * (mats * live * d * f + live * c * d + e * c * d)
        + 4 * e * counts)


def _work(x, wg, wi, wo, counts=None, *, gated: bool) -> dict:
    """`cost` of a call with every expert live (a count reads no
    values)."""
    e, c, d = x.shape
    return cost(e, e, c, d, wg.shape[-1], x.dtype, gated=gated,
                counts=counts is not None)


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def build(verbose: bool = False) -> str:
    """Compile `csrc/moe_gmm.cu` into `kernels/build/` (once per source
    content) and return the shared library's path."""
    return common.build(SOURCE, verbose)


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.moe_gmm_launch.argtypes = [vp] * 7 + [ci] * 6 + [vp] + [
        ctypes.POINTER(ci)]
    lib.moe_gmm_launch.restype = ci


def _check(x, wg, wi, wo, counts, gated: bool) -> None:
    if x.dtype not in _DTYPES:
        raise ValueError(f"moe_gmm kernel takes bf16 or f32, not {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x has shape {tuple(x.shape)}: expected (E, C, D)")
    e, _, d = x.shape
    f = wg.shape[-1] if wg.dim() == 3 else -1
    if f < 1:
        raise ValueError(f"wg has shape {tuple(wg.shape)}: expected "
                         f"({e}, {d}, F) with F >= 1")
    want = {"x": (x, x.shape), "wg": (wg, (e, d, f)), "wo": (wo, (e, f, d))}
    if gated:
        want["wi"] = (wi, (e, d, f))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, x is "
                             f"{x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if counts is not None and (
            counts.device != x.device or counts.dtype != torch.int32
            or tuple(counts.shape) != (e,) or not counts.is_contiguous()):
        raise ValueError(f"counts must be a contiguous ({e},) int32 tensor "
                         f"on {x.device}")


ROUTES = ("mma", "fma")


def _launch(x, wg, wi, wo, counts, gated: bool) -> tuple[torch.Tensor, str]:
    """Check the operands, allocate h and the output and launch both
    stages on the current stream; the output and the route taken."""
    _check(x, wg, wi, wo, counts, gated)
    e, c, d = x.shape
    f = wg.shape[-1]
    lib = common.library(SOURCE, _declare)
    h = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    route = ctypes.c_int(0)
    err = lib.moe_gmm_launch(
        x.data_ptr(), wg.data_ptr(), wi.data_ptr() if gated else None,
        wo.data_ptr(), counts.data_ptr() if counts is not None else None,
        h.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], e, c, d, f,
        int(gated), stream, ctypes.byref(route))
    if err != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed: CUDA error {err}")
    return out, "mma" if route.value == 1 else "fma"


def moe_gmm(x, wg, wi, wo, *, gated: bool = True, use_kernel=None):
    """The grouped expert FFN of every expert (see the module docstring).
    CUDA tensors launch the kernel; CPU tensors, or `use_kernel="plain"`,
    run `moe_gmm_plain`; `use_kernel="kernel"` raises on CPU.  Under a
    cost counter CPU and meta tensors take the kernel's route
    (`common.stand_in`)."""
    how = common.route(use_kernel, x.device)
    if how == "plain":
        return moe_gmm_plain(x, wg, wi, wo, gated=gated)
    # the ungated form reads no wi: it is not an input of the function
    wi = wi if gated else None
    if how == "stand-in":
        plain = functools.partial(moe_gmm_plain, gated=gated)
        return common.with_plain_vjp(moe_gmm, common.stand_in(
            "moe_gmm", functools.partial(_work, gated=gated), plain,
            lambda x, *_: torch.empty_like(x)), plain, x, wg, wi, wo)
    return _with_plain_vjp(x, wg, wi, wo, gated=gated)


def _with_plain_vjp(x, wg, wi, wo, *, gated: bool):
    """The kernel, with `moe_gmm_plain`'s gradient."""
    return common.with_plain_vjp(
        moe_gmm, functools.partial(_kernel, gated=gated),
        functools.partial(moe_gmm_plain, gated=gated), x, wg, wi, wo)


def _kernel(x, wg, wi, wo, *, gated: bool) -> torch.Tensor:
    with _cost.kernel("moe_gmm", lambda: _work(x, wg, wi, wo, gated=gated)):
        out, route = _launch(x, wg, wi, wo, None, gated)
    moe_gmm.launches += 1
    moe_gmm.routes[route] += 1
    return out


def moe_gmm_skip(x, wg, wi, wo, counts, *, gated: bool = True,
                 use_kernel=None):
    """The grouped expert FFN of the experts with counts[e] > 0, exact
    zeros for the others, whose weights the kernel never reads.  Device
    rule as `moe_gmm`'s."""
    how = common.route(use_kernel, x.device)
    if how == "plain":
        return moe_gmm_skip_plain(x, wg, wi, wo, counts, gated=gated)
    common.no_vjp("moe_gmm_skip", x, wg, wi, wo)
    if how == "stand-in":
        return common.stand_in(
            "moe_gmm_skip", functools.partial(_work, gated=gated),
            functools.partial(moe_gmm_skip_plain, gated=gated),
            lambda x, *_: torch.empty_like(x))(x, wg, wi, wo, counts)
    with _cost.kernel("moe_gmm_skip", lambda: _work(
            x, wg, wi, wo, counts, gated=gated)):
        out, route = _launch(x, wg, wi, wo, counts, gated)
    moe_gmm_skip.launches += 1
    moe_gmm_skip.routes[route] += 1
    return out


moe_gmm.launches = 0
moe_gmm.backward_recomputes = 0
moe_gmm_skip.launches = 0
moe_gmm.routes = dict.fromkeys(ROUTES, 0)
moe_gmm_skip.routes = dict.fromkeys(ROUTES, 0)
