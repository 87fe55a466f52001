"""Exact-equality helpers shared by the port's parity suites
(test_torch_*.py): a
port result (torch tensors) against the JAX package's (jax arrays), field
by field, tolerance 0; `assert_tree_equal` the same for nested host
values (sched reports, logs and snapshots)."""
import dataclasses

import jax
import numpy as np
import torch

from repro_torch.core import isa as tisa
from repro_torch.core import simulator as tsim

DEV = "cpu"

# the parity suites run long chains of tiny tensor ops; under pytest-xdist
# several workers share the host, and torch's intra-op thread pool then
# only adds contention (a 7 s test took 50 s with two 8-thread workers)
torch.set_num_threads(1)


def synthetic_fleet(b=2, p=3, n=4_000, seed=1234):
    rng = np.random.default_rng(seed)
    return rng.integers(0, tisa.NUM_INSTRUCTIONS, (b, p, n)).astype(np.int32)


def assert_equal(t_res, j_res):
    """Field-by-field exact equality of a port NamedTuple and JAX's."""
    for name, a, b in zip(t_res._fields, t_res, j_res):
        np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(b),
                                      err_msg=f"field {name}")


def assert_state_equal(t_state, j_state):
    want = jax.tree_util.tree_map(np.asarray, j_state)
    got = tsim.fleet_state_to_numpy(t_state)
    for name in ("slot_st", "bs_st"):
        for f, a, b in zip(("tags", "last_use", "clock"),
                           getattr(got, name), getattr(want, name)):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f}")
    for name in tsim.FleetState._fields[2:]:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def assert_tree_equal(got, want, path="root"):
    """Exact equality of two nested values of dicts, lists, tuples, numpy
    arrays and Python scalars — types included, so a port snapshot or
    report is the reference's value, not merely an equal one.  Dataclasses
    (reports, placements) compare field by field."""
    if dataclasses.is_dataclass(want):
        assert dataclasses.is_dataclass(got), path
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(want)], path
        for f in dataclasses.fields(want):
            assert_tree_equal(getattr(got, f.name), getattr(want, f.name),
                              f"{path}.{f.name}")
        return
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), path
    else:
        assert got == want, (path, got, want)


def without_seconds(log):
    """A `resolve_log` (list of dicts) with its wall-clock field dropped:
    the only field that may differ between the packages."""
    return [{k: v for k, v in row.items() if k != "seconds"} for row in log]
