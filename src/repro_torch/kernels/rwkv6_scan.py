"""RWKV6 WKV recurrence: Hopper kernel and its plain versions.

PyTorch port of the JAX package's Pallas kernel
`repro.kernels.rwkv6_scan.rwkv6_scan` and of the recurrences the JAX
model runs in its place (`repro.models.rwkv6.recurrence_scan`, and
`recurrence_chunked` when T % 64 == 0: the same function in another
summation order).  Per head, with r, k, v, logw (B, T, H, N), the bonus u
(H, N) and the state S (B, H, N, N) keyed [key, value]:

    o_t = r_t @ (S + diag(u k_t) 1 v_t^T)
    S   <- diag(exp(logw_t)) S + k_t v_t^T

in f32, from S0 (zero when None).  All versions return (o (B, T, H, N)
f32, S_T (B, H, N, N) f32): the Pallas kernel starts from zero and
returns o only, the model needs both ends of the state.

* `rwkv6_scan_plain`: `recurrence_scan`'s per-token loop; any device.
* `rwkv6_scan_chunked_plain`: the chunked route's algebra in plain
  PyTorch (sub-chunks of L = 16 tokens in state-passing form, the same
  reference points, decay factors multiplied up from exp(logw) and the
  zero-filled tail), for the CPU tests, and the body whose
  vector-Jacobian product is the kernel's backward in training (a loop
  over T / 16 sub-chunks, where the plain version's runs over all of T).
* the CUDA kernel `csrc/rwkv6_scan.cu` for `sm_90a` (r/k/v bf16 or f32,
  logw f32; N 16, 32 or 64), two routes chosen in its C entry point from
  the shapes and the operands' alignment: "chunked" (T >= 32,
  16-byte aligned operands: every prefill) is two kernels, a parallel
  pass over every sub-chunk of 16 tokens (the decayed r and k and the
  intra-sub-chunk matrix A, into a scratch this wrapper allocates) and a
  state pass on a grid of (head, batch row, block of 32 value columns)
  that keeps the state in registers for the whole of T and runs the
  inter, intra and state products on the tensor cores (`mma.sync`, f32
  operands split into bf16 hi + lo); "step" (T < 32, e.g. decode, or
  unaligned operands) walks
  the tokens one CTA per (head, batch row), thread j on the state's value
  column j.  Built with `nvcc` at first use, bound with ctypes.

`rwkv6_scan` owns the choice: CUDA tensors launch the kernel (and count it
in `rwkv6_scan.launches`, and the route it took in `rwkv6_scan.routes`,
e.g. `{"chunked": 16, "step": 128}`) or raise, CPU tensors run the plain
version; `use_kernel="plain"` forces the plain version anywhere.  Where
autograd records, the kernel's backward is `rwkv6_scan_chunked_plain`'s
vector-Jacobian product (`common.KernelVjp`, counted in
`rwkv6_scan.backward_recomputes`); the gradients of r, k and v come back
in their dtype.  The Pallas kernel's `chunk` is a TPU tiling knob with no
counterpart here.  `cost` is the kernel's count for a cost counter
(`analysis.cost`) and its bound.
"""
from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.analysis import cost as _cost
from repro_torch.kernels import common

__all__ = ["rwkv6_scan", "rwkv6_scan_plain", "rwkv6_scan_chunked_plain",
           "build", "cost", "HEAD_DIMS", "ROUTES", "SUB_CHUNK"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "rwkv6_scan.cu")
HEAD_DIMS = (16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("chunked", "step")
SUB_CHUNK = 16          # L: tokens a sub-chunk of the chunked route


def rwkv6_scan_plain(r, k, v, logw, u, s0=None):
    """r, k, v, logw: (B, T, H, N); u: (H, N); s0: (B, H, N, N) or None.
    Returns (o (B, T, H, N) f32, S_T (B, H, N, N) f32)."""
    b, t, h, n = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(logw.float())
    uf = u.float()
    s = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    out = torch.empty((b, t, h, n), dtype=torch.float32, device=r.device)
    for i in range(t):
        rt, kt, vt, wt = rf[:, i], kf[:, i], vf[:, i], w[:, i]
        kv = kt[..., :, None] * vt[..., None, :]
        att = s + (uf[None] * kt)[..., :, None] * vt[..., None, :]
        out[:, i] = torch.einsum("bhk,bhkv->bhv", rt, att)
        s = wt[..., :, None] * s + kv
    return out, s


def rwkv6_scan_chunked_plain(r, k, v, logw, u, s0=None, sub_chunk=SUB_CHUNK):
    """The chunked route's algebra: sub-chunks of `sub_chunk` tokens in
    state-passing form, T zero-filled to a whole sub-chunk (logw 0 leaves
    the decay untouched; the fill's rows are dropped).  With cl / clp the
    inclusive / exclusive log-decay cumsums from the sub-chunk's start:

        o  = (r exp(clp)) @ S + A v,  A[t, s] = sum_n r k exp(clp_t - cl_s)
             (s < t), A[t, t] = sum_n r u k
        S <- diag(exp(cl_L)) S + (k exp(cl_L - cl))^T v

    Every factor is <= 1 and is the product of the per-step decays
    exp(logw) it spans, as the kernel multiplies them up, never the
    exponential of a difference of cumsums (which would cancel: at logw
    -20 a step cl reaches -320 within a sub-chunk, and f32 keeps it to
    ~3e-5).  The kernel runs the products on bf16 hi + lo splits.  Same
    arguments and results as `rwkv6_scan_plain`."""
    b, t, h, n = r.shape
    lc = sub_chunk
    pad = -t % lc
    f = lambda x: torch.nn.functional.pad(
        x.float().permute(0, 2, 1, 3), (0, 0, 0, pad))   # (B, H, T', N)
    rf, kf, vf, w = f(r), f(k), f(v), torch.exp(f(logw))
    uf = u.float()[None, :, None, :]
    s = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    pos = torch.arange(lc, device=r.device)
    # [t, m]: m before t, m after t; [t, s, m]: s < m < t
    before = pos[None, :] < pos[:, None]
    after = pos[None, :] > pos[:, None]
    between = (pos[None, :, None] < pos[None, None, :]) & \
        (pos[None, None, :] < pos[:, None, None])
    span = lambda wc, mask, dim: torch.where(mask, wc, 1.0).prod(dim)
    outs = []
    for c0 in range(0, t + pad, lc):
        rc, kc, vc, wc = (x[:, :, c0:c0 + lc] for x in (rf, kf, vf, w))
        w_t = wc[:, :, None, :, :]                      # (B, H, 1, m, N)
        decay_r = span(w_t, before[:, :, None], 3)      # exp(clp)
        decay_k = span(w_t, after[:, :, None], 3)       # exp(cl_L - cl)
        decay_a = span(wc[:, :, None, None], between[..., None], 4)
        decay_a = torch.where(before[:, :, None], decay_a, 0.0)   # s < t
        a = torch.einsum("bhtn,bhsn,bhtsn->bhts", rc, kc, decay_a)
        a = a + torch.diag_embed((rc * uf * kc).sum(-1))
        outs.append((rc * decay_r) @ s + a @ vc)
        s = wc.prod(2, keepdim=True).transpose(2, 3) * s + \
            (kc * decay_k).transpose(2, 3) @ vc
    out = torch.cat(outs, 2)[:, :, :t].permute(0, 2, 1, 3)
    return out.contiguous(), s


def cost(b: int, t: int, h: int, n: int, dtype: torch.dtype,
         s0: bool) -> dict:
    """The kernel's count (`analysis.cost.work`): 4 N^2 f32 operations a
    token and head (the state's update and its read); r, k, v (in
    `dtype`), the f32 decays, the bonus and s0 read once, o and the final
    state written once."""
    elem = torch.empty((), dtype=dtype).element_size()
    return _cost.work(4 * n * n * b * t * h, "f32",
                      (3 * elem + 4) * b * t * h * n + 4 * h * n
                      + 4 * b * h * n * n * s0 + 4 * b * t * h * n
                      + 4 * b * h * n * n)


def _work(r, k, v, logw, u, s0) -> dict:
    b, t, h, n = r.shape
    return cost(b, t, h, n, r.dtype, s0 is not None)


def _empty_outputs(r, *_):
    b, t, h, n = r.shape
    return (torch.empty((b, t, h, n), dtype=torch.float32, device=r.device),
            torch.empty((b, h, n, n), dtype=torch.float32, device=r.device))


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def build(verbose: bool = False) -> str:
    """Compile `csrc/rwkv6_scan.cu` into `kernels/build/` (once per source
    content) and return the shared library's path."""
    return common.build(SOURCE, verbose)


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_scan_launch.argtypes = [vp] * 8 + [ci] * 5 + [
        vp, vp, ctypes.POINTER(ci)]
    lib.rwkv6_scan_launch.restype = ci
    lib.rwkv6_chunked_scratch_bytes.argtypes = [ci] * 5
    lib.rwkv6_chunked_scratch_bytes.restype = ctypes.c_longlong


def _check(r, k, v, logw, u, s0) -> None:
    if r.dtype not in _DTYPES:
        raise ValueError(f"rwkv6 kernel takes bf16 or f32 r/k/v, not "
                         f"{r.dtype}")
    if r.dim() != 4:
        raise ValueError(f"r has shape {tuple(r.shape)}: expected "
                         f"(B, T, H, N)")
    b, _, h, n = r.shape
    if n not in HEAD_DIMS:
        raise ValueError(f"rwkv6 kernel takes head dim {HEAD_DIMS}, "
                         f"not {n}")
    want = {"r": (r, r.dtype, r.shape), "k": (k, r.dtype, r.shape),
            "v": (v, r.dtype, r.shape),
            "logw": (logw, torch.float32, r.shape),
            "u": (u, torch.float32, (h, n))}
    if s0 is not None:
        want["s0"] = (s0, torch.float32, (b, h, n, n))
    for name, (t, dtype, shape) in want.items():
        if (t.device != r.device or t.dtype != dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                             f"{dtype} tensor on {r.device}, not "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _launch(r, k, v, logw, u, s0):
    """Check the operands, allocate o, the final state and the chunked
    route's scratch and launch the kernel on the current stream; (o, S_T)
    and the route taken."""
    _check(r, k, v, logw, u, s0)
    b, t, h, n = r.shape
    lib = common.library(SOURCE, _declare)
    o = torch.empty((b, t, h, n), dtype=torch.float32, device=r.device)
    s_out = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    # the chunked route's record of every sub-chunk, where it may be taken
    nbytes = lib.rwkv6_chunked_scratch_bytes(_DTYPES[r.dtype], b, t, h, n)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=r.device)
               if nbytes else None)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    route = ctypes.c_int(0)
    err = lib.rwkv6_scan_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), s0.data_ptr() if s0 is not None else None,
        o.data_ptr(), s_out.data_ptr(), _DTYPES[r.dtype], b, t, h, n,
        scratch.data_ptr() if scratch is not None else None, stream,
        ctypes.byref(route))
    if err != 0:
        raise RuntimeError(f"rwkv6 kernel launch failed: CUDA error {err}")
    return (o, s_out), "chunked" if route.value == 1 else "step"


def rwkv6_scan(r, k, v, logw, u, s0=None, *, use_kernel=None):
    """The WKV recurrence from s0 (see the module docstring).  Returns (o
    (B, T, H, N) f32, S_T (B, H, N, N) f32).  CUDA tensors launch the
    kernel on the route its entry point picks; CPU tensors, or
    `use_kernel="plain"`, run `rwkv6_scan_plain`; `use_kernel="kernel"`
    raises on CPU.  Under a cost counter CPU and meta tensors take the
    kernel's route (`common.stand_in`)."""
    how = common.route(use_kernel, r.device)
    if how == "plain":
        return rwkv6_scan_plain(r, k, v, logw, u, s0)
    if how == "stand-in":
        return common.with_plain_vjp(
            rwkv6_scan, common.stand_in(
                "rwkv6_scan", _work, rwkv6_scan_plain, _empty_outputs),
            rwkv6_scan_chunked_plain, r, k, v, logw, u, s0)
    return _with_plain_vjp(r, k, v, logw, u, s0)


def _with_plain_vjp(r, k, v, logw, u, s0):
    """The kernel, with `rwkv6_scan_chunked_plain`'s gradient."""
    return common.with_plain_vjp(rwkv6_scan, _kernel,
                                 rwkv6_scan_chunked_plain, r, k, v, logw, u,
                                 s0)


def _kernel(r, k, v, logw, u, s0):
    with _cost.kernel("rwkv6_scan", lambda: _work(r, k, v, logw, u, s0)):
        out, route = _launch(r, k, v, logw, u, s0)
    rwkv6_scan.launches += 1
    rwkv6_scan.routes[route] += 1
    return out


rwkv6_scan.launches = 0
rwkv6_scan.backward_recomputes = 0
rwkv6_scan.routes = dict.fromkeys(ROUTES, 0)
