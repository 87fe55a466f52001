"""RG-LRU recurrence: Hopper kernel and its plain versions.

PyTorch port of the JAX package's Pallas kernel
`repro.kernels.rglru_scan.rglru_scan` and of the scans the JAX model runs
in its place (`repro.models.rglru.rglru_scan`, a chunked associative scan,
and `rglru_step` at decode): for the conv output u (B, T, W) and the gate
parameters w_r, b_r, w_i, b_i, lam (W,) f32,

    r = sigmoid(u w_r + b_r),  i = sigmoid(u w_i + b_i)
    a = exp(-8 softplus(lam) r),  b = sqrt(max(1 - a^2, 1e-12)) (i u)
    h_t = a_t h_{t-1} + b_t

all in f32, from h0 (B, W) f32 (zero when None).  All versions return
(h (B, T, W) f32, h_last (B, W) f32): the Pallas kernel starts from zero
and returns h only, the model needs both ends of the state.

* `rglru_scan_plain`: the gates at once, then a sequential loop over t;
  any device.
* `rglru_scan_chunked_plain`: the chunked route's algebra in plain
  PyTorch (per-chunk aggregates, the carry across chunks, the rescan of
  each chunk from its true start), for the CPU tests, and the body whose
  vector-Jacobian product is the kernel's backward in training (a loop
  of 64 steps, where the plain version's runs over all of T).
* the CUDA kernel `csrc/rglru_scan.cu` for `sm_90a` (u bf16 or f32, read
  in its own type), two routes chosen in its C entry point from the
  shapes: "chunked" (T > 64: every prefill) scans chunks of 64 steps in
  parallel over (channel block, batch row, chunk), one pass writing each
  chunk's aggregate to a scratch this wrapper allocates, a second
  carrying h to each chunk's start and rescanning it; "step" (T <= 64,
  e.g. decode) walks t, one thread per (batch row, channel).  Built with
  `nvcc` at first use, bound with ctypes.

`rglru_scan` owns the choice: CUDA tensors launch the kernel (and count it
in `rglru_scan.launches`, and the route it took in `rglru_scan.routes`)
or raise, CPU tensors run the plain version; `use_kernel="plain"` forces
the plain version anywhere.  Where autograd records, the kernel's backward
is `rglru_scan_chunked_plain`'s vector-Jacobian product
(`common.KernelVjp`, counted in `rglru_scan.backward_recomputes`); the
gradient of u comes back in u's dtype.  The Pallas kernel's
`chunk`/`block_w` are TPU tiling knobs with no counterpart here.  `cost`
is the kernel's count for a cost counter (`analysis.cost`) and its bound.
"""
from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from repro_torch.analysis import cost as _cost
from repro_torch.kernels import common

__all__ = ["rglru_scan", "rglru_scan_plain", "rglru_scan_chunked_plain",
           "build", "cost", "C_RGLRU", "CHUNK", "ROUTES", "OPS_PER_ELEM"]

C_RGLRU = 8.0
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "rglru_scan.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("chunked", "step")
CHUNK = 64              # steps a chunk of the kernel's chunked route
# f32 operations an element of the recurrence takes: two sigmoids, the
# softplus-scaled decay, an exp, a sqrt and the FMA
OPS_PER_ELEM = 22


def _gates(u, w_r, b_r, w_i, b_i, lam):
    """(a, b) of the recurrence h_t = a_t h_{t-1} + b_t, in f32:
    `repro.models.rglru._gates`."""
    uf = u.float()
    r = torch.sigmoid(uf * w_r + b_r)
    i = torch.sigmoid(uf * w_i + b_i)
    log_a = -C_RGLRU * F.softplus(lam.float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * \
        (i * uf)
    return a, b


def rglru_scan_plain(u, w_r, b_r, w_i, b_i, lam, h0=None):
    """u: (B, T, W); gate params (W,) f32; h0 (B, W) f32 or None.
    Returns (h (B, T, W) f32, h_last (B, W) f32)."""
    a, b = _gates(u, w_r, b_r, w_i, b_i, lam)
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0.float()
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out, h


def rglru_scan_chunked_plain(u, w_r, b_r, w_i, b_i, lam, h0=None,
                             chunk=CHUNK):
    """The chunked route's algebra: per chunk of `chunk` steps the
    aggregate (A = prod a, B = the chunk's scan from zero), h carried
    across the chunks through the aggregates (h = A h + B), then each
    chunk rescanned from its true start with the plain version's gates
    and FMA chain.  T is filled to a whole chunk with a = 1, b = 0 (steps
    that leave h as it is; their rows are dropped).  Same arguments and
    results as `rglru_scan_plain`."""
    a, b = _gates(u, w_r, b_r, w_i, b_i, lam)
    bsz, t, w = a.shape
    pad = -t % chunk
    a = torch.nn.functional.pad(a, (0, 0, 0, pad), value=1.0)
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    a = a.reshape(bsz, -1, chunk, w)
    b = b.reshape(bsz, -1, chunk, w)
    agg_a, agg_b = torch.ones_like(a[:, :, 0]), torch.zeros_like(b[:, :, 0])
    for s in range(chunk):
        agg_b = a[:, :, s] * agg_b + b[:, :, s]
        agg_a = agg_a * a[:, :, s]
    h = torch.zeros_like(a[:, 0, 0]) if h0 is None else h0.float()
    starts = []
    for c in range(a.shape[1]):
        starts.append(h)
        h = agg_a[:, c] * h + agg_b[:, c]
    h = torch.stack(starts, 1)
    out = torch.empty_like(a)
    for s in range(chunk):
        h = a[:, :, s] * h + b[:, :, s]
        out[:, :, s] = h
    out = out.reshape(bsz, -1, w)[:, :t]
    return out, out[:, -1]


def cost(b: int, t: int, w: int, dtype: torch.dtype, h0: bool) -> dict:
    """The kernel's count (`analysis.cost.work`): OPS_PER_ELEM f32
    operations an element; u (in `dtype`), the five gate vectors and h0
    read once, h and h_last written once."""
    elem = torch.empty((), dtype=dtype).element_size()
    return _cost.work(OPS_PER_ELEM * b * t * w, "f32",
                      elem * b * t * w + 5 * 4 * w + 4 * b * w * h0
                      + 4 * b * t * w + 4 * b * w)


def _work(u, w_r, b_r, w_i, b_i, lam, h0) -> dict:
    b, t, w = u.shape
    return cost(b, t, w, u.dtype, h0 is not None)


def _empty_outputs(u, *_):
    b, t, w = u.shape
    return (torch.empty((b, t, w), dtype=torch.float32, device=u.device),
            torch.empty((b, w), dtype=torch.float32, device=u.device))


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def build(verbose: bool = False) -> str:
    """Compile `csrc/rglru_scan.cu` into `kernels/build/` (once per source
    content) and return the shared library's path."""
    return common.build(SOURCE, verbose)


def _declare(lib) -> None:
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rglru_scan_launch.argtypes = [vp, ci, ci, ci, ci, cl, cl,
                                      ctypes.POINTER(vp), vp, vp, vp, vp,
                                      vp, ctypes.POINTER(ci)]
    lib.rglru_scan_launch.restype = ci
    lib.rglru_chunked_scratch_bytes.argtypes = [ci, ci, ci]
    lib.rglru_chunked_scratch_bytes.restype = cl


def _launch(u, params, h0):
    """Check the operands, allocate h, h_last and the chunked route's
    scratch and launch the kernel on the current stream; (h, h_last) and
    the route taken."""
    if u.dtype not in _DTYPES:
        raise ValueError(f"rglru kernel takes bf16 or f32 u, not {u.dtype}")
    if u.dim() != 3 or u.stride(-1) != 1:
        raise ValueError(f"u has shape {tuple(u.shape)}, strides "
                         f"{u.stride()}: expected (B, T, W) with a "
                         f"contiguous last dimension")
    b, t, w = u.shape
    for name, p in zip(("w_r", "b_r", "w_i", "b_i", "lam"), params):
        if (p.device != u.device or p.dtype != torch.float32
                or tuple(p.shape) != (w,) or not p.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({w},) f32 "
                             f"tensor on {u.device}")
    if h0 is not None and (h0.device != u.device or h0.dtype != torch.float32
                           or tuple(h0.shape) != (b, w)
                           or not h0.is_contiguous()):
        raise ValueError(f"h0 must be a contiguous ({b}, {w}) f32 tensor on "
                         f"{u.device}")
    lib = common.library(SOURCE, _declare)
    h = torch.empty((b, t, w), dtype=torch.float32, device=u.device)
    h_last = torch.empty((b, w), dtype=torch.float32, device=u.device)
    # each chunk's (prod a, scan from zero), every chunk but the last
    nbytes = lib.rglru_chunked_scratch_bytes(b, t, w)
    agg = (torch.empty(nbytes, dtype=torch.uint8, device=u.device)
           if nbytes else None)
    ptrs = (ctypes.c_void_p * 5)(*(p.data_ptr() for p in params))
    stream = torch.cuda.current_stream(u.device).cuda_stream
    route = ctypes.c_int(0)
    err = lib.rglru_scan_launch(
        u.data_ptr(), _DTYPES[u.dtype], b, t, w, u.stride(0), u.stride(1),
        ptrs, h0.data_ptr() if h0 is not None else None, h.data_ptr(),
        h_last.data_ptr(), agg.data_ptr() if agg is not None else None,
        stream, ctypes.byref(route))
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {err}")
    return (h, h_last), "chunked" if route.value == 1 else "step"


def rglru_scan(u, w_r, b_r, w_i, b_i, lam, h0=None, *, use_kernel=None):
    """The RG-LRU scan of u (B, T, W) from h0 (see the module docstring).
    Returns (h (B, T, W) f32, h_last (B, W) f32).  CUDA tensors launch the
    kernel on the route its entry point picks; CPU tensors, or
    `use_kernel="plain"`, run `rglru_scan_plain`; `use_kernel="kernel"`
    raises on CPU.  Under a cost counter CPU and meta tensors take the
    kernel's route (`common.stand_in`)."""
    how = common.route(use_kernel, u.device)
    if how == "plain":
        return rglru_scan_plain(u, w_r, b_r, w_i, b_i, lam, h0)
    if how == "stand-in":
        return common.with_plain_vjp(
            rglru_scan, common.stand_in(
                "rglru_scan", _work, rglru_scan_plain, _empty_outputs),
            rglru_scan_chunked_plain, u, w_r, b_r, w_i, b_i, lam, h0)
    return _with_plain_vjp(u, w_r, b_r, w_i, b_i, lam, h0)


def _with_plain_vjp(u, w_r, b_r, w_i, b_i, lam, h0):
    """The kernel, with `rglru_scan_chunked_plain`'s gradient."""
    return common.with_plain_vjp(rglru_scan, _kernel,
                                 rglru_scan_chunked_plain, u, w_r, b_r, w_i,
                                 b_i, lam, h0)


def _kernel(u, w_r, b_r, w_i, b_i, lam, h0):
    with _cost.kernel("rglru_scan", lambda: _work(
            u, w_r, b_r, w_i, b_i, lam, h0)):
        out, route = _launch(u, (w_r, b_r, w_i, b_i, lam), h0)
    rglru_scan.launches += 1
    rglru_scan.routes[route] += 1
    return out


rglru_scan.launches = 0
rglru_scan.backward_recomputes = 0
rglru_scan.routes = dict.fromkeys(ROUTES, 0)
