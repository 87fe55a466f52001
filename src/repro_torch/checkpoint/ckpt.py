"""Checkpointing with an integrity manifest: PyTorch port of
`repro.checkpoint.ckpt`, in its on-disk layout.

Layout:   <dir>/step_<k>/
              manifest.json        {step, tree structure, leaf checksums}
              arr_<i>.npy          one file per leaf

Leaves are numbered in `jax.tree_util`'s flatten order of the same tree
(`repro_torch.tree_util`: NamedTuple fields in order, dict keys sorted,
lists in order, `None` no leaf), each leaf's manifest entry holds its
shape, dtype name and the sha1 of its bytes, and bfloat16 (float8_e4m3fn)
leaves are stored as raw uint16 (uint8) views with the logical dtype in
the manifest.  So a checkpoint that either package writes restores leaf
for leaf in the other.  A save is written to a temporary directory and
renamed into place: a crashed save leaves no manifest, so `latest_step`
never returns a partial checkpoint.  `restore` checks every sha1 and puts
the leaves on a device.  Each leaf's file and sha1 are written, or read
and checked, on one of `IO_THREADS` threads, up to `IO_WINDOW` leaves
ahead of the caller (hashlib and the file calls release the GIL); the
copies between the card and the host, and the gathers under a mesh, run
in the caller's thread in the leaves' order.

Under a mesh (`plan`, one process a rank; `specs` the tree's specs, e.g.
`train.step.state_shardings`) the tree holds each rank's blocks: `save`
gathers each leaf to its global shape on every rank, one leaf at a time,
and rank 0 writes it in the same layout, so either package restores it;
`restore` reads every leaf whole and keeps this rank's block, which is
the reference's re-shard onto a mesh (`restore(..., shardings)`).
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree_util import leaves, tree_map, unflatten

__all__ = ["save", "AsyncSaver", "latest_step", "restore", "IO_THREADS"]

IO_THREADS = 8     # leaves hashed and read or written at once
IO_WINDOW = 16     # leaves held on the host at once beyond those
# seconds the threads spent on leaves ("work") and the caller spent
# waiting for them ("wait"), summed over every save and restore: the
# caller's path is shorter than a serial one by about work - wait
IO_SECONDS = {"work": 0.0, "wait": 0.0}
_IO_LOCK = threading.Lock()

# numpy has no bfloat16 / float8: stored as raw views, the logical dtype
# in the manifest
# logical dtype name: (its torch dtype, the stored numpy dtype, the raw
# dtype numpy and torch share for the bytes)
_EXOTIC = {"bfloat16": (torch.bfloat16, np.uint16, np.int16),
           "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, np.uint8)}
_RAW = {np.int16: torch.int16, np.uint8: torch.uint8}
_BY_TORCH = {v[0]: k for k, v in _EXOTIC.items()}


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(the array to store, the logical dtype name) of a leaf: a tensor
    (copied to the host) or a numpy array."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu()
    if t.dtype in _BY_TORCH:
        name = _BY_TORCH[t.dtype]
        _, stored, raw = _EXOTIC[name]
        return t.view(_RAW[raw]).numpy().view(stored), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _sha1(arr: np.ndarray) -> str:
    """The sha1 of `arr.tobytes()`, hashed in place."""
    return hashlib.sha1(np.ascontiguousarray(arr).data).hexdigest()


def _write(path: str, stored: np.ndarray) -> str:
    """Write one leaf's array to `path`; its sha1."""
    np.save(path, stored)
    return _sha1(stored)


def _account(key: str, t0: float) -> None:
    with _IO_LOCK:
        IO_SECONDS[key] += time.perf_counter() - t0


def _timed(fn, *a):
    t0 = time.perf_counter()
    try:
        return fn(*a)
    finally:
        _account("work", t0)


def _in_order(fn, args):
    """`fn(*a)` for each `a` of the iterable `args` on IO_THREADS threads,
    at most IO_WINDOW of them pending, yielded in order (`args` is drawn
    in the caller's thread as the results are taken)."""
    def take(future):
        t0 = time.perf_counter()
        try:
            return future.result()
        finally:
            _account("wait", t0)

    with ThreadPoolExecutor(IO_THREADS) as pool:
        pending = collections.deque()
        for a in args:
            pending.append(pool.submit(_timed, fn, *a))
            if len(pending) > IO_WINDOW:
                yield take(pending.popleft())
        while pending:
            yield take(pending.popleft())


def _structure(tree) -> str:
    """The tree's structure as text, '*' a leaf (the manifest's
    `treedef`; neither package reads it back)."""
    return str(tree_map(lambda _: "*", tree))


def save(directory: str, step: int, tree, plan=None, specs=None) -> str:
    """Write `tree` as step `step`; returns the checkpoint's path.  Under
    `plan` every rank calls it with its blocks (see the module
    docstring) and returns when the checkpoint is in place."""
    from repro_torch.sharding.partition import state_spec_leaves
    flat = leaves(tree)
    spec = [None] * len(flat) if plan is None else state_spec_leaves(specs)
    writes = plan is None or plan.mesh.rank == 0
    final = os.path.join(directory, f"step_{step:08d}")
    if writes:
        os.makedirs(directory, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
        manifest = {"step": step, "treedef": _structure(tree), "leaves": []}

    def host_leaves():
        # every rank gathers each leaf in turn; rank 0 writes it
        for i, (leaf, sp) in enumerate(zip(flat, spec, strict=True)):
            if plan is not None:
                leaf = plan.relayout(leaf, sp, ())
            if writes:
                stored, dtype_name = _to_numpy(leaf)
                manifest["leaves"].append({"shape": list(stored.shape),
                                           "dtype": dtype_name})
                yield os.path.join(tmp, f"arr_{i}.npy"), stored

    digests = list(_in_order(_write, host_leaves()))
    if writes:
        for entry, digest in zip(manifest["leaves"], digests, strict=True):
            entry["sha1"] = digest
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
    if plan is not None:
        plan.mesh.barrier()   # the others return once it is published
    return final


class AsyncSaver:
    """Overlap checkpoint writes with training: `save()` copies the
    leaves to host memory (blocking only for those copies) and writes
    them on a background thread; `wait()` joins before the next save or
    shutdown — the write-then-rename protocol keeps partial saves
    invisible either way.  The host copies are the saver's own, so the
    caller may update the tensors in place meanwhile."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, directory: str, step: int, tree) -> None:
        self.wait()
        host_tree = tree_map(
            lambda leaf: leaf.detach().to("cpu", copy=True)
            if isinstance(leaf, torch.Tensor) else np.array(leaf), tree)

        def work():
            try:
                save(directory, step, host_tree)
            except BaseException as e:  # noqa: BLE001 — surfaced in wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(directory: str, step: int, like_tree, device="cuda", plan=None,
            specs=None):
    """Load the step-k checkpoint into the structure of `like_tree` (e.g.
    `train.step.abstract_state`'s meta tensors), each leaf a tensor on
    `device` in its stored dtype; under `plan` this rank's block of each
    by `specs` (a tree of specs like `like_tree`).  Raises IOError on a
    checksum mismatch."""
    from repro_torch.sharding.partition import state_spec_leaves
    dev = resolve_device(device)
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    n = len(leaves(like_tree))
    if n != len(manifest["leaves"]):
        raise ValueError(f"tree structure changed: {n} leaves, the "
                         f"checkpoint has {len(manifest['leaves'])}")
    spec = [None] * n if plan is None else state_spec_leaves(specs)

    def read(i: int) -> np.ndarray:
        arr = np.load(os.path.join(path, f"arr_{i}.npy"))
        if _sha1(arr) != manifest["leaves"][i]["sha1"]:
            raise IOError(f"checksum mismatch for leaf {i} at step {step}")
        return arr

    arrays = _in_order(read, ((i,) for i in range(n)))
    return unflatten(like_tree, [
        _to_tensor(arr, want["dtype"], sp, plan, dev)
        for arr, want, sp in zip(arrays, manifest["leaves"], spec,
                                 strict=True)])


def _to_tensor(arr: np.ndarray, dtype: str, sp, plan, dev) -> torch.Tensor:
    """A stored leaf as a tensor on `dev` in its logical dtype; under
    `plan` this rank's block by spec `sp`."""
    if dtype in _EXOTIC:
        logical, _, raw = _EXOTIC[dtype]
        t = torch.from_numpy(arr.view(raw)).view(logical)
    else:
        t = torch.from_numpy(arr)
    if plan is not None:
        t = plan.local_shard(t, sp)
    return t.to(dev, copy=plan is not None)
