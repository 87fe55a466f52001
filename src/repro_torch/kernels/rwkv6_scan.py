"""RWKV6 WKV recurrence: Hopper kernel and its plain version.

PyTorch port of the JAX package's Pallas kernel
`repro.kernels.rwkv6_scan.rwkv6_scan` and of the recurrences the JAX
model runs in its place (`repro.models.rwkv6.recurrence_scan`, and
`recurrence_chunked` when T % 64 == 0: the same function in another
summation order).  Per head, with r, k, v, logw (B, T, H, N), the bonus u
(H, N) and the state S (B, H, N, N) keyed [key, value]:

    o_t = r_t @ (S + diag(u k_t) 1 v_t^T)
    S   <- diag(exp(logw_t)) S + k_t v_t^T

in f32, from S0 (zero when None).  Both versions return (o (B, T, H, N)
f32, S_T (B, H, N, N) f32): the Pallas kernel starts from zero and
returns o only, the model needs both ends of the state.

* `rwkv6_scan_plain`: `recurrence_scan`'s per-token loop; any device.
* the CUDA kernel `csrc/rwkv6_scan.cu` for `sm_90a` (r/k/v bf16 or f32,
  logw f32; N 16, 32 or 64): one CTA per (head, batch row), thread j
  holding the state's value column j.  Built with `nvcc` at first use,
  bound with ctypes.

`rwkv6_scan` owns the choice: CUDA tensors launch the kernel (and count it
in `rwkv6_scan.launches`) or raise, CPU tensors run the plain version;
`use_kernel="plain"` forces the plain version anywhere.  The Pallas
kernel's `chunk` is a TPU tiling knob with no counterpart here.
"""
from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.kernels import common

__all__ = ["rwkv6_scan", "rwkv6_scan_plain", "build", "HEAD_DIMS"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "rwkv6_scan.cu")
HEAD_DIMS = (16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def build(verbose: bool = False) -> str:
    """Compile `csrc/rwkv6_scan.cu` into `kernels/build/` (once per source
    content) and return the shared library's path."""
    return common.build(SOURCE, verbose)


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_scan_launch.argtypes = [vp] * 8 + [ci] * 5 + [vp]
    lib.rwkv6_scan_launch.restype = ci


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
    """Check the operands, allocate o and the final state and launch the
    kernel on the current stream."""
    _check(r, k, v, logw, u, s0)
    b, t, h, n = r.shape
    lib = common.library(SOURCE, _declare)
    o = torch.empty((b, t, h, n), dtype=torch.float32, device=r.device)
    s_out = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = lib.rwkv6_scan_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), s0.data_ptr() if s0 is not None else None,
        o.data_ptr(), s_out.data_ptr(), _DTYPES[r.dtype], b, t, h, n,
        stream)
    if err != 0:
        raise RuntimeError(f"rwkv6 kernel launch failed: CUDA error {err}")
    return o, s_out


def rwkv6_scan(r, k, v, logw, u, s0=None, *, use_kernel=None):
    """The WKV recurrence from s0 (see the module docstring).  Returns (o
    (B, T, H, N) f32, S_T (B, H, N, N) f32).  CUDA tensors launch the
    kernel; CPU tensors, or `use_kernel="plain"`, run `rwkv6_scan_plain`;
    `use_kernel="kernel"` raises on CPU."""
    if not common.resolve(use_kernel, r.device) or r.device.type != "cuda":
        return rwkv6_scan_plain(r, k, v, logw, u, s0)
    out = _launch(r, k, v, logw, u, s0)
    rwkv6_scan.launches += 1
    return out


rwkv6_scan.launches = 0
