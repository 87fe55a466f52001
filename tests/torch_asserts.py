"""Exact-equality helpers shared by the port's parity suites
(test_torch_*.py): a
port result (torch tensors) against the JAX package's (jax arrays), field
by field, tolerance 0."""
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
