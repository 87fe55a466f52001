"""What every kernel of the port shares: the `use_kernel` knob, the
gradient rule and the `nvcc` build into `kernels/build/`.

Gradients: the JAX package trains through no Pallas kernel and defines no
backward kernel, so the port writes none.  A kernel that lies on the
training path (flash attention, `moe_gmm`, the two scans) runs its
forward through `with_plain_vjp`: when autograd records, the launch goes
through `KernelVjp`, whose backward re-runs the wrapper's plain body on
the saved inputs and returns its vector-Jacobian product, the gradient of
the function the reference differentiates.  A kernel on no training path
(decode attention, `moe_gmm_skip`) calls `no_vjp` before it launches and
raises where autograd would record.

Under a cost counter (`repro_torch.analysis.cost`) on the CPU or the meta
device, `route` sends a wrapper to its kernel's stand-in (`stand_in`):
the card's route with the kernel's launch replaced by its plain body
(empty outputs on meta), charged the kernel's count, so that a counted
step takes the card's route, its backward included, on every device.

Each kernel is one CUDA C++ source under `csrc/` with a plain C entry
point.  `build` compiles it for `sm_90a` at first use, into a shared
library named by the sha1 of the source, its local headers and the flags
(so a changed source builds anew and concurrent builds race safely),
and `library` loads it with `ctypes`.  A source that needs flags of its
own beyond `NVCC_FLAGS` names them on a line `// nvcc-flags: ...`.  Nothing here runs at import: the
CPU has no `nvcc`, and the CPU tests import every module.

Every wrapper's `_launch` runs under `on_tensor_device`: a ctypes entry
point launches on the *current* device and sets its kernel's attributes
there (`cudaFuncSetAttribute`), while its stream comes from the tensor's
device, so the launch makes the first tensor's card current for its
span.  With one card per rank, or a tensor on another card than the
current one, the kernel runs where its operands lie.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

import torch

from repro_torch.analysis import cost

__all__ = ["resolve", "route", "stand_in", "with_plain_vjp", "no_vjp",
           "KernelVjp", "on_tensor_device", "build", "library",
           "ptxas_report",
           "BUILD_DIR", "NVCC_FLAGS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
_LIBS: dict[str, ctypes.CDLL] = {}
_REPORTS: dict[str, str] = {}


def on_tensor_device(launch):
    """`launch(x, ...)` run with `x`'s card as the current device."""
    @functools.wraps(launch)
    def guarded(x, *args, **kwargs):
        with torch.cuda.device(x.device):
            return launch(x, *args, **kwargs)
    return guarded


def resolve(use_kernel, device: torch.device) -> bool:
    """Resolve a `use_kernel` knob for tensors on `device` to "call the
    wrapper" (True) or "run the plain body" (False).  The wrappers own the
    device choice: they launch the kernel on CUDA tensors and run the
    plain body on CPU tensors.

    None/'auto' -> the wrapper; True/'kernel' -> the wrapper, raising here
    on CPU tensors (there is no interpret mode); False/'plain' -> the
    plain body on any device.
    """
    mode = use_kernel
    if mode is None:
        mode = "auto"
    elif mode is True:
        mode = "kernel"
    elif mode is False:
        mode = "plain"
    if mode not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown use_kernel value {use_kernel!r} "
                         f"(expected None/bool or 'auto'|'kernel'|'plain')")
    if mode == "kernel" and torch.device(device).type != "cuda":
        raise ValueError(
            "use_kernel='kernel' needs CUDA tensors: the port's kernels are "
            "CUDA-only (no interpret mode); use 'auto' or 'plain' on the CPU")
    return mode != "plain"


def route(use_kernel, device: torch.device) -> str:
    """Where a wrapper sends a call on tensors on `device`: "kernel" (CUDA
    tensors), "stand-in" (CPU or meta tensors under a cost counter:
    `stand_in`) or "plain" (the plain body, or `use_kernel="plain"`)."""
    if not resolve(use_kernel, device):
        return "plain"
    if torch.device(device).type == "cuda":
        return "kernel"
    return "stand-in" if cost.counting() is not None else "plain"


def stand_in(name: str, count, body, meta):
    """The launch of kernel `name` on the "stand-in" route: charged
    `count(*inputs)` (the kernel's `cost` dict) under the active counters,
    it returns `body(*inputs)` (the plain body, whose ops are not
    counted), or `meta(*inputs)` (empty outputs of the kernel's shapes)
    on the meta device."""
    def launch(*inputs):
        with cost.kernel(name, lambda: count(*inputs)):
            if inputs[0].device.type == "meta":
                return meta(*inputs)
            return body(*inputs)
    return launch


def _recorded(inputs) -> bool:
    """Would autograd record an op on `inputs`?"""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs)


class KernelVjp(torch.autograd.Function):
    """A kernel's forward with its plain body's gradient.

    `apply(owner, launch, plain, *inputs)`: `launch(*inputs)` runs the
    kernel (and counts it); `plain(*inputs)` is the same function in
    differentiable PyTorch.  The inputs are tensors or None (an absent
    state, which gets no gradient); the arguments that are not tensors
    are bound into `launch` and `plain`.  The backward runs `plain` under
    grad on detached copies of the saved inputs, returns
    `torch.autograd.grad` of it for each input that needs one, in that
    input's dtype, and adds one to `owner.backward_recomputes`."""

    @staticmethod
    def forward(ctx, owner, launch, plain, *inputs):
        ctx.owner, ctx.plain = owner, plain
        ctx.save_for_backward(*inputs)
        return launch(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]

        def run():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(inputs, need)]
            wanted = [t for t, n in zip(leaves, need) if n]
            with torch.enable_grad():
                outs = ctx.plain(*leaves)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wanted, [g for _, g in pairs],
                allow_unused=True))
            ctx.owner.backward_recomputes += 1
            return (None, None, None,
                    *(next(got) if n else None for n in need))

        if inputs[0].device.type != "meta" or cost.counting() is None:
            return run()
        # counted on meta: the layers repeat this backward at these shapes
        return cost.replay((_function_key(ctx.plain), _layout(inputs),
                            need, _layout(grads)), run)


def _layout(tensors) -> tuple:
    return tuple(None if t is None else (tuple(t.shape), t.stride(), t.dtype)
                 for t in tensors)


def _function_key(fn) -> tuple:
    """A hashable description of `fn`, a function or a partial of one."""
    if isinstance(fn, functools.partial):
        return (fn.func, fn.args, tuple(sorted(fn.keywords.items())))
    return (fn,)


def with_plain_vjp(owner, launch, plain, *inputs):
    """`launch(*inputs)`, through `KernelVjp` when autograd records (grad
    enabled and an input requires grad), so that the gradient reaches the
    inputs as the plain body's vector-Jacobian product."""
    if _recorded(inputs):
        return KernelVjp.apply(owner, launch, plain, *inputs)
    return launch(*inputs)


def no_vjp(name: str, *inputs) -> None:
    """Refuse to launch kernel `name`, which has no gradient, where
    autograd would record (grad enabled and an input requires grad)."""
    if _recorded(inputs):
        raise RuntimeError(
            f"{name} lies on no training path and has no gradient: call it "
            f"under torch.no_grad(), or pass use_kernel='plain' to "
            f"differentiate its plain version")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the port's kernels are built from source at first "
                       "use")


def _text_with_headers(source: str) -> bytes:
    """The source's bytes followed by those of each local header it
    includes (`#include "x.cuh"`, beside it): the library's name keys on
    all of them."""
    with open(source, "rb") as f:
        text = f.read()
    out = text
    for name in re.findall(rb'^#include "([^"]+)"', text, re.M):
        with open(os.path.join(os.path.dirname(source), name.decode()),
                  "rb") as f:
            out += f.read()
    return out


def _source_flags(source: str) -> list[str]:
    """The flags a source asks for on its `// nvcc-flags:` lines."""
    with open(source) as f:
        return [flag for line in f for flag in (
            line[len("// nvcc-flags:"):].split()
            if line.startswith("// nvcc-flags:") else ())]


def build(source: str, verbose: bool = False) -> str:
    """Compile `source` (a `csrc/*.cu` file) into `kernels/build/` (once
    per source content) and return the shared library's path.  With
    `verbose`, print what `-Xptxas=-v` reports (registers, shared memory,
    spills) when it compiles."""
    flags = NVCC_FLAGS + _source_flags(source)
    digest = hashlib.sha1(_text_with_headers(source) +
                          " ".join(flags).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    lib = os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:12]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *flags, "-o", tmp, source]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} ({r.returncode}):"
                               f"\n{r.stderr}")
        if verbose:
            _REPORTS[source] = r.stdout + r.stderr
            print(_REPORTS[source], end="", flush=True)
        os.replace(tmp, lib)   # atomic: concurrent builds race safely
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def ptxas_report(source: str) -> dict:
    """Registers and spill bytes of each kernel of `source`, from the
    `-Xptxas=-v` report of its last verbose build in this process
    (empty if it was not built so): {symbol: {"registers", "spill_stores",
    "spill_loads"}}, the symbols demangled far enough to read (template
    arguments kept)."""
    out, name = {}, None
    for line in _REPORTS.get(source, "").splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return {_readable(k): v for k, v in out.items()}


def _readable(symbol: str) -> str:
    """`..._ZN...18flash_kernel_wgmmaILi256EEEv...` -> `flash_kernel_wgmma<256>`
    (the kernel's name and its type and integer template arguments)."""
    for m in re.finditer(r"(\d+)([A-Za-z_])", symbol):
        n, start = int(m.group(1)), m.start(2)
        name = symbol[start:start + n]
        if "kernel" in name and symbol[start + n:start + n + 1] == "I":
            rest = symbol[start + n + 1:symbol.find("EEv", start + n)]
            parts = ["float" if k == "f" else "bf16"
                     for k in re.findall(r"(?:^|I)(f|13__nv_bfloat16)", rest)]
            parts += re.findall(r"Li(\d+)E", rest + "E")
            return f"{name}<{', '.join(parts)}>"
    return symbol


def library(source: str, declare) -> ctypes.CDLL:
    """The loaded library of `source`, built at first use; `declare(lib)`
    sets its functions' `argtypes`/`restype` once, when it loads."""
    lib = _LIBS.get(source)
    if lib is None:
        lib = ctypes.CDLL(build(source))
        declare(lib)
        _LIBS[source] = lib
    return lib
