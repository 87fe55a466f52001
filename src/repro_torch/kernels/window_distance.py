"""The interleaved engine's window pass: Hopper kernel and plain version.

PyTorch port of the JAX package's Pallas kernel
`repro.kernels.window_distance` (`window_grid`, `window_cell`, loop body
`_window_loop`).  Each cell of a {quantum x fleet x slots x latency} grid
runs the window loop until `total_steps` accesses committed; one trip
commits one scheduler window of the scheduled program: gather its next W
tags/costs, take each access's stack distance in the merged stream from a
per-tag cummax seeded with the carried `last_pos`, classify cold/miss,
cumsum the cycle costs from the open quantum, cut at the first quantum
expiry and fold the committed prefix back into the carry (module docstring
of `repro_torch.core.stackdist_interleaved`).

Two implementations, bit-for-bit equal (all int32):

* the CUDA kernel `csrc/window_distance.cu` for `sm_90a`: one CTA per
  cell, the per-tag vectors in shared memory for the whole run.  It is
  built with `nvcc` from the source in this package at first use into
  `kernels/build/` and bound with `ctypes`;
* the plain version (`window_loop_plain`, exposed with the kernel's
  signatures as `window_grid_plain` / `window_cell_plain`): the batched
  PyTorch body, every cell a row of one batch stepped in a Python loop
  until all cells are done (a finished cell freezes).  The CPU tests run
  it, and `chip_smoke.py` holds the kernel against it on the card.

`window_grid` and `window_cell` dispatch on the device of their tensors:
CUDA tensors launch the kernel (or raise), CPU tensors run the plain
version.  Each counts its kernel launches in a plain integer attribute
(`window_grid.launches`, `window_cell.launches`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import NamedTuple

import torch

__all__ = ["window_grid", "window_cell", "window_grid_plain",
           "window_cell_plain", "window_loop_plain", "resolve", "build",
           "Carry"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "window_distance.cu")
BUILD_DIR = os.path.join(_HERE, "build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
# a block may use 227 KB of dynamic shared memory on Hopper; the kernel's
# static shared memory is a few dozen bytes on top
_SMEM_LIMIT = 232_448 - 1_024


def resolve(use_kernel, device: torch.device) -> bool:
    """Resolve a `use_kernel` knob for tensors on `device` to "call the
    wrapper" (True) or "run the plain body" (False).  The wrappers
    (`window_grid`, `window_cell`) own the device choice: they launch the
    kernel on CUDA tensors and run the plain body on CPU tensors.

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
            "use_kernel='kernel' needs CUDA tensors: the window kernel is "
            "CUDA-only (no interpret mode); use 'auto' or 'plain' on the CPU")
    return mode != "plain"


# ---------------------------------------------------------------------------
# plain version: the batched PyTorch window loop
# ---------------------------------------------------------------------------


class Carry(NamedTuple):
    """Batched cell carry: `CellCarry` with a leading cell axis C."""

    last_pos: torch.Tensor   # (C, T)
    last_miss: torch.Tensor  # (C, T)
    cursors: torch.Tensor    # (C, P)
    sched_idx: torch.Tensor  # (C,)
    steps_done: torch.Tensor  # (C,)
    q_cycles: torch.Tensor   # (C,)
    cycles: torch.Tensor     # (C, P)
    instrs: torch.Tensor     # (C, P)
    misses: torch.Tensor     # (C, P)
    bs_misses: torch.Tensor  # (C, P)
    switches: torch.Tensor   # (C,)


def cold_carry(cells: int, num_progs: int, num_tags: int,
               device) -> Carry:
    """Carry of `cells` cells that start cold (step 0, empty caches)."""
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    neg = torch.full((cells, num_tags), -1, dtype=torch.int32, device=device)
    return Carry(last_pos=neg, last_miss=neg.clone(),
                 cursors=z(cells, num_progs), sched_idx=z(cells),
                 steps_done=z(cells), q_cycles=z(cells),
                 cycles=z(cells, num_progs), instrs=z(cells, num_progs),
                 misses=z(cells, num_progs), bs_misses=z(cells, num_progs),
                 switches=z(cells))


def window_loop_plain(ptags: torch.Tensor, pcosts: torch.Tensor,
                      cell_fleet: torch.Tensor, num_active: torch.Tensor,
                      miss_latency: torch.Tensor, quanta: torch.Tensor,
                      schedule: torch.Tensor, handler, bs_extra,
                      init: Carry, *, total_steps: int, window: int,
                      pos_base: int, materialise: bool) -> Carry:
    """Run C cells of the window loop to `total_steps` committed accesses.

    `ptags`/`pcosts` are (B, P, N) int32 pre-gathered tag/cost streams and
    `cell_fleet` (C,) picks each cell's fleet; `num_active`, `miss_latency`
    (C,) and `quanta` (C, P) are the cells' coordinates, `schedule` the
    weighted round-robin turn order shared by every cell.  `init` seeds
    the carry (its `steps_done` must be 0).  This is the reference's
    `vmap^4` over a `lax.while_loop` written out: one Python trip per
    window over the whole batch, with a cell whose steps are done frozen
    exactly as a vmapped while-loop selects the old carry for it.
    """
    dev = ptags.device
    _, num_progs, trace_len = ptags.shape
    num_tags = init.last_pos.shape[1]
    sched_len = schedule.shape[0]
    flat_tags = ptags.reshape(-1)
    flat_costs = pcosts.reshape(-1)
    row_base = cell_fleet.long() * num_progs
    warange = torch.arange(window, dtype=torch.int32, device=dev)
    tag_ids = torch.arange(num_tags, dtype=torch.int32, device=dev)
    parange = torch.arange(num_progs, device=dev)
    handler = torch.as_tensor(handler, dtype=torch.int32, device=dev)
    bs_extra = torch.as_tensor(bs_extra, dtype=torch.int32, device=dev)
    c = init
    while True:
        active = c.steps_done < total_steps
        if not bool(active.any()):
            return c
        p = schedule[c.sched_idx.long()].long()
        cur = c.cursors.gather(1, p[:, None])[:, 0]
        idx = torch.remainder(cur[:, None] + warange, trace_len)
        flat = (row_base + p)[:, None] * trace_len + idx.long()
        w_tags = flat_tags[flat]
        w_hw = flat_costs[flat]
        slotted = w_tags >= 0

        # merged-stream stack distances for the whole window in one pass
        pos = pos_base + c.steps_done[:, None] + warange
        match = w_tags[:, :, None] == tag_ids
        occ = torch.where(match, pos[:, :, None], -1)
        cm = torch.cummax(occ, dim=1).values
        lp = c.last_pos[:, None, :]
        prev = torch.cat([lp, torch.maximum(cm[:, :-1], lp)], dim=1)
        safe = w_tags.clamp(min=0).long()
        prev_self = prev.gather(2, safe[:, :, None])[:, :, 0]
        cold = slotted & (prev_self < 0)
        dist = (prev > prev_self[:, :, None]).sum(2, dtype=torch.int32)
        miss = slotted & (cold | (dist >= num_active[:, None]))

        cost = (w_hw + miss.to(torch.int32) * miss_latency[:, None]
                + cold.to(torch.int32) * bs_extra)
        cum = c.q_cycles[:, None] + torch.cumsum(cost, 1, dtype=torch.int32)
        quantum = quanta.gather(1, p[:, None])[:, 0]
        expire = cum >= quantum[:, None]
        any_exp = expire.any(1)
        first = torch.where(expire, warange, window).min(1).values
        n_exp = torch.where(any_exp, first + 1, window)
        remaining = total_steps - c.steps_done
        n = torch.minimum(n_exp, remaining)
        do_switch = any_exp & (n_exp <= remaining)

        last_row = (n - 1).clamp(min=0).long()   # frozen cells: n <= 0
        committed = cm.gather(
            1, last_row[:, None, None].expand(-1, 1, num_tags))[:, 0]
        if materialise:
            cm_miss = torch.cummax(
                torch.where(match & miss[:, :, None], pos[:, :, None], -1),
                dim=1).values
            last_miss = torch.maximum(c.last_miss, cm_miss.gather(
                1, last_row[:, None, None].expand(-1, 1, num_tags))[:, 0])
        else:
            last_miss = c.last_miss
        end_cum = cum.gather(1, last_row[:, None])[:, 0]
        run_cycles = (end_cum - c.q_cycles
                      + do_switch.to(torch.int32) * handler)
        in_run = warange < n[:, None]
        onehot = (parange == p[:, None]).to(torch.int32)
        new = Carry(
            last_pos=torch.maximum(c.last_pos, committed),
            last_miss=last_miss,
            cursors=c.cursors + onehot * n[:, None],
            sched_idx=torch.where(do_switch, (c.sched_idx + 1) % sched_len,
                                  c.sched_idx),
            steps_done=c.steps_done + n,
            q_cycles=torch.where(do_switch, 0, end_cum),
            cycles=c.cycles + onehot * run_cycles[:, None],
            instrs=c.instrs + onehot * n[:, None],
            misses=c.misses + onehot * (miss & in_run).sum(
                1, dtype=torch.int32)[:, None],
            bs_misses=c.bs_misses + onehot * (cold & in_run).sum(
                1, dtype=torch.int32)[:, None],
            switches=c.switches + do_switch.to(torch.int32),
        )
        c = Carry(*(torch.where(
            active.view((-1,) + (1,) * (x.dim() - 1)), x, old).to(
                torch.int32) for x, old in zip(new, c)))


def _grid_cells(nq: int, nb: int, nk: int, nl: int, device):
    """(Q, B, K, L) row-major cell coordinates, each (C,) long."""
    q, b, k, l = torch.meshgrid(
        *(torch.arange(n, device=device) for n in (nq, nb, nk, nl)),
        indexing="ij")
    return q.reshape(-1), b.reshape(-1), k.reshape(-1), l.reshape(-1)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def window_grid_plain(ptags, pcosts, slot_counts, miss_latencies, quanta,
                      schedule, handler, bs_miss_extra, *, num_tags: int,
                      total_steps: int, window: int):
    """Plain version of `window_grid` (same signature and results)."""
    dev = ptags.device
    nb, num_progs, _ = ptags.shape
    counts = _i32(slot_counts, dev).reshape(-1)
    lats = _i32(miss_latencies, dev).reshape(-1)
    quanta = _i32(quanta, dev)
    nq, nk, nl = quanta.shape[0], counts.shape[0], lats.shape[0]
    q, b, k, l = _grid_cells(nq, nb, nk, nl, dev)
    final = window_loop_plain(
        ptags, pcosts, b, counts[k], lats[l], quanta[q],
        _i32(schedule, dev).reshape(-1), handler, bs_miss_extra,
        cold_carry(q.shape[0], num_progs, num_tags, dev),
        total_steps=int(total_steps), window=int(window), pos_base=0,
        materialise=False)
    pshape = (nq, nb, nk, nl, num_progs)
    return (final.cycles.reshape(pshape), final.instrs.reshape(pshape),
            final.misses.reshape(pshape), final.bs_misses.reshape(pshape),
            final.switches.reshape(pshape[:-1]))


def _seed_carry(seed, num_progs: int, num_tags: int, device) -> Carry:
    if seed is None:
        return cold_carry(1, num_progs, num_tags, device)
    (s_last, s_cursors, s_sched, s_qc, s_cycles, s_instrs, s_misses,
     s_bsm, s_switches) = seed
    v = lambda x: _i32(x, device).reshape(1, -1)
    s = lambda x: _i32(x, device).reshape(1)
    return Carry(last_pos=v(s_last),
                 last_miss=torch.full((1, num_tags), -1, dtype=torch.int32,
                                      device=device),
                 cursors=v(s_cursors), sched_idx=s(s_sched),
                 steps_done=torch.zeros(1, dtype=torch.int32, device=device),
                 q_cycles=s(s_qc), cycles=v(s_cycles), instrs=v(s_instrs),
                 misses=v(s_misses), bs_misses=v(s_bsm),
                 switches=s(s_switches))


def window_cell_plain(ptags, pcosts, num_active, miss_latency, quanta,
                      schedule, handler, bs_miss_extra, seed=None, *,
                      num_tags: int, total_steps: int, window: int,
                      seeded: bool | None = None, materialise: bool = True):
    """Plain version of `window_cell` (same signature and results)."""
    if seeded is None:
        seeded = seed is not None
    dev = ptags.device
    num_progs = ptags.shape[0]
    final = window_loop_plain(
        ptags[None], pcosts[None], torch.zeros(1, dtype=torch.long,
                                               device=dev),
        _i32(num_active, dev).reshape(1), _i32(miss_latency, dev).reshape(1),
        _i32(quanta, dev).reshape(1, num_progs),
        _i32(schedule, dev).reshape(-1), handler, bs_miss_extra,
        _seed_carry(seed, num_progs, num_tags, dev),
        total_steps=int(total_steps), window=int(window),
        pos_base=num_tags if seeded else 0, materialise=bool(materialise))
    return tuple(x[0] for x in final)


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the window kernel is built from source at first use")


def build(verbose: bool = False) -> str:
    """Compile `csrc/window_distance.cu` into `kernels/build/` (once per
    source content) and return the shared library's path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_NVCC_FLAGS).encode())
    lib = os.path.join(BUILD_DIR, f"window_distance-{digest.hexdigest()[:12]}"
                                  f".so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, SOURCE]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        if verbose:
            print(r.stdout + r.stderr, end="")
        os.replace(tmp, lib)   # atomic: concurrent builders race safely
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.window_distance_launch.argtypes = [vp] * 13 + [ci] * 14 + [vp]
        lib.window_distance_launch.restype = ci
        lib.window_distance_smem_bytes.argtypes = [ci, ci]
        lib.window_distance_smem_bytes.restype = ctypes.c_size_t
        _LIB = lib
    return _LIB


def _check(name: str, t: torch.Tensor, shape: tuple,
           device: torch.device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected torch.int32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t


def _ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _launch(ptags, pcosts, counts, lats, quanta, schedule, seed, *,
            handler: int, bs_extra: int, num_tags: int, total_steps: int,
            window: int, pos_base: int, materialise: bool,
            want_tags: bool):
    """Check the operands, allocate the outputs and launch the kernel on
    the current stream.  Returns (out_vec (C,5,P), out_sca (C,4),
    out_last (C,T) | None, out_miss (C,T) | None)."""
    dev = ptags.device
    nb, num_progs, trace_len = ptags.shape
    nq, nk, nl = quanta.shape[0], counts.shape[0], lats.shape[0]
    sched_len = schedule.shape[0]
    if min(num_progs, trace_len, sched_len, num_tags, window) < 1:
        raise ValueError("window kernel needs P, N, S, num_tags and window "
                         ">= 1")
    _check("ptags", ptags, (nb, num_progs, trace_len), dev)
    _check("pcosts", pcosts, (nb, num_progs, trace_len), dev)
    _check("slot_counts", counts, (nk,), dev)
    _check("miss_latencies", lats, (nl,), dev)
    _check("quanta", quanta, (nq, num_progs), dev)
    _check("schedule", schedule, (sched_len,), dev)
    lib = _library()
    smem = lib.window_distance_smem_bytes(num_tags, num_progs)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"num_tags={num_tags} with P={num_progs} needs {smem} bytes of "
            f"shared memory per block, above the {_SMEM_LIMIT} a Hopper "
            f"block holds")
    if seed is not None:
        s_last, s_vec, s_sca = seed
        _check("seed last_pos", s_last, (num_tags,), dev)
        _check("seed vectors", s_vec, (5, num_progs), dev)
        _check("seed scalars", s_sca, (3,), dev)
    cells = nq * nb * nk * nl
    out_vec = torch.empty((cells, 5, num_progs), dtype=torch.int32,
                          device=dev)
    out_sca = torch.empty((cells, 4), dtype=torch.int32, device=dev)
    out_last = out_miss = None
    if want_tags:
        out_last = torch.empty((cells, num_tags), dtype=torch.int32,
                               device=dev)
        out_miss = torch.empty_like(out_last)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.window_distance_launch(
        _ptr(ptags), _ptr(pcosts), _ptr(counts), _ptr(lats), _ptr(quanta),
        _ptr(schedule), *(_ptr(x) for x in (seed or (None,) * 3)),
        _ptr(out_vec), _ptr(out_sca), _ptr(out_last), _ptr(out_miss),
        nb, num_progs, trace_len, nq, nk, nl, sched_len, num_tags,
        int(handler), int(bs_extra), int(total_steps), int(window),
        int(pos_base), int(bool(materialise)), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"window kernel launch failed: CUDA error {err}")
    return out_vec, out_sca, out_last, out_miss


def window_grid(ptags, pcosts, slot_counts, miss_latencies, quanta,
                schedule, handler, bs_miss_extra, *, num_tags: int,
                total_steps: int, window: int):
    """One-shot counter sweep: (B, P, N) pre-gathered tag/cost streams ->
    (cycles, instrs, misses, bs_misses) as (Q, B, K, L, P) int32 and
    switches as (Q, B, K, L), one cell per point of the (Q, B, K, L) grid.

    CUDA tensors launch the kernel (one CTA per cell) and count it in
    `window_grid.launches`; CPU tensors run `window_grid_plain`.
    `handler` and `bs_miss_extra` are Python ints (a 0-d tensor is read
    back to the host)."""
    if ptags.device.type != "cuda":
        return window_grid_plain(
            ptags, pcosts, slot_counts, miss_latencies, quanta, schedule,
            handler, bs_miss_extra, num_tags=num_tags,
            total_steps=total_steps, window=window)
    dev = ptags.device
    nb, num_progs, _ = ptags.shape
    counts = _i32(slot_counts, dev).reshape(-1)
    lats = _i32(miss_latencies, dev).reshape(-1)
    quanta = _i32(quanta, dev)
    out_vec, out_sca, _, _ = _launch(
        ptags, pcosts, counts, lats, quanta, _i32(schedule, dev).reshape(-1),
        None, handler=int(handler), bs_extra=int(bs_miss_extra),
        num_tags=num_tags, total_steps=total_steps, window=window,
        pos_base=0, materialise=False, want_tags=False)
    window_grid.launches += 1
    shape = (quanta.shape[0], nb, counts.shape[0], lats.shape[0])
    pshape = shape + (num_progs,)
    return (out_vec[:, 1].reshape(pshape), out_vec[:, 2].reshape(pshape),
            out_vec[:, 3].reshape(pshape), out_vec[:, 4].reshape(pshape),
            out_sca[:, 3].reshape(shape))


window_grid.launches = 0


def window_cell(ptags, pcosts, num_active, miss_latency, quanta, schedule,
                handler, bs_miss_extra, seed=None, *, num_tags: int,
                total_steps: int, window: int, seeded: bool | None = None,
                materialise: bool = True):
    """One cell: (P, N) streams (+ optional engine-coordinate seed) -> the
    11 `CellCarry` fields in declaration order.  `seed` is (last_pos,
    cursors, sched_idx, q_cycles, cycles, instrs, misses, bs_misses,
    switches); None starts cold.  Seeded runs place segment positions at
    `pos_base = num_tags`, above the seed's virtual block.

    CUDA tensors launch the kernel (one CTA) and count it in
    `window_cell.launches`; CPU tensors run `window_cell_plain`."""
    if ptags.device.type != "cuda":
        return window_cell_plain(
            ptags, pcosts, num_active, miss_latency, quanta, schedule,
            handler, bs_miss_extra, seed, num_tags=num_tags,
            total_steps=total_steps, window=window, seeded=seeded,
            materialise=materialise)
    if seeded is None:
        seeded = seed is not None
    dev = ptags.device
    num_progs = ptags.shape[0]
    kseed = None
    if seed is not None:
        (s_last, s_cursors, s_sched, s_qc, s_cycles, s_instrs, s_misses,
         s_bsm, s_switches) = seed
        kseed = (_i32(s_last, dev).reshape(-1).contiguous(),
                 torch.stack([_i32(x, dev).reshape(-1) for x in
                              (s_cursors, s_cycles, s_instrs, s_misses,
                               s_bsm)]),
                 torch.stack([_i32(x, dev).reshape(()) for x in
                              (s_sched, s_qc, s_switches)]))
    out_vec, out_sca, out_last, out_miss = _launch(
        ptags[None].contiguous(), pcosts[None].contiguous(),
        _i32(num_active, dev).reshape(1), _i32(miss_latency, dev).reshape(1),
        _i32(quanta, dev).reshape(1, num_progs).contiguous(),
        _i32(schedule, dev).reshape(-1).contiguous(), kseed,
        handler=int(handler), bs_extra=int(bs_miss_extra),
        num_tags=num_tags, total_steps=total_steps, window=window,
        pos_base=num_tags if seeded else 0, materialise=materialise,
        want_tags=True)
    window_cell.launches += 1
    v, s = out_vec[0], out_sca[0]
    return (out_last[0], out_miss[0], v[0], s[0], s[1], s[2], v[1], v[2],
            v[3], v[4], s[3])


window_cell.launches = 0
