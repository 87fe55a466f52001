"""The test side of the GSPMD training tests (`test_torch_gspmd_train.py`,
`test_torch_gspmd_dp.py`): the reference's `state_shardings` on the
mesh's shape (`state_specs`), and the checks that hold every rank's
blocks of a case (`torch_gspmd_train_checks._case`'s output) to the
reference's arrays (`jax_gspmd_train_reference.py`'s): the loss, every
gradient block, three steps' metrics, the state after them and each
block's shape.  `strategy` is the plans' `strategy_override`."""
import jax
import numpy as np

import gspmd_asserts as ga
import torch_gspmd_train_checks as chk
from repro.optim import adamw as jadamw
from repro.sharding.partition import ShardingPlan as JPlan
from repro.train import step as jstep

TOL = 1e-5
NORM_RTOL = 1e-5
# where the reference's own GSPMD and one-device results sit farther apart
# than TOL, the port is held within this many times their gap
SPREAD = 2.0


def _is_spec(x) -> bool:
    return isinstance(x, jax.sharding.PartitionSpec)


def state_specs(case, strategy=None):
    """The reference's `state_shardings` as PartitionSpecs, with the
    whole state's shapes, each a list in jax's flatten order of the
    state, and the `TrainState` of specs."""
    cfg = ga.jconfig(case)
    opt = chk.opt_config(jadamw, case)
    shapes = jstep.abstract_state(cfg, opt)
    plan = JPlan(ga.FakeMesh(chk.MESH), cfg, mode="train", fsdp=case.fsdp,
                 strategy_override=strategy)
    zero1 = JPlan(ga.FakeMesh(chk.MESH), cfg, mode="train", fsdp=True,
                  strategy_override=strategy)
    specs = jadamw.TrainState(
        step=jax.sharding.PartitionSpec(),
        params=plan.param_specs(shapes.params),
        m=zero1.param_specs(shapes.m), v=zero1.param_specs(shapes.v),
        master=(None if shapes.master is None
                else zero1.param_specs(shapes.master)))
    flat = jax.tree_util.tree_leaves(specs, is_leaf=_is_spec)
    return flat, jax.tree_util.tree_leaves(shapes), specs


def fields(specs) -> list:
    """Each state leaf's field name, in jax's flatten order."""
    return [f for f in specs._fields if getattr(specs, f) is not None
            for _ in jax.tree_util.tree_leaves(getattr(specs, f),
                                               is_leaf=_is_spec)]


def hold(ranks, get, want, one, spec, what: str) -> None:
    """Every rank's block (`get(rank)`) of a leaf within relative L2 `tol`
    of its block of the reference's `want`, and the blocks put together
    within `tol` of it: `tol` is TOL, or SPREAD times the reference's own
    gap to `one` (its result without a plan) where that is larger."""
    tol = max(TOL, SPREAD * ga.rel(one, want))
    whole = np.full(want.shape, np.nan)
    for r in ranks:
        sl = ga.block(spec, want.shape, r["coords"])
        got = get(r).numpy()
        assert got.shape == want[sl].shape, (what, r["coords"])
        assert ga.rel(got, want[sl]) <= tol, (what, r["coords"], tol)
        whole[sl] = got
    assert ga.rel(whole, want) <= tol, (what, tol)


def hold_loss(ranks, ref, case) -> None:
    """The first batch's loss on every rank within TOL."""
    want = float(ref[f"{case.name}_loss"])
    for r in ranks:
        assert abs(r[case.name]["loss"] - want) <= TOL * abs(want)


def hold_grads(ranks, ref, case, strategy=None) -> None:
    """Every leaf's gradient on every rank, its ZeRO-1 block (m's spec)
    summed over the ranks, against the same block of the reference's
    `jax.grad` under the plan (`hold`)."""
    _, _, specs = state_specs(case, strategy)
    m_specs = jax.tree_util.tree_leaves(specs.m, is_leaf=_is_spec)
    assert len(ranks[0][case.name]["grads"]) == len(m_specs)
    for i, spec in enumerate(m_specs):
        hold(ranks, lambda r: r[case.name]["grads"][i],
             ref[f"{case.name}_grad{i}"], ref[f"{case.name}_grad_one{i}"],
             spec, f"{case.name} grad {i}")


def hold_metrics(ranks, ref, case) -> None:
    """Each step's loss, grad norm and learning rate on every rank within
    NORM_RTOL (or SPREAD times the reference's own gap)."""
    for k in range(chk.TRAIN_STEPS):
        for key in ("loss", "grad_norm", "lr"):
            want = float(ref[f"{case.name}_step{k}_{key}"])
            one = float(ref[f"{case.name}_one_step{k}_{key}"])
            tol = max(NORM_RTOL, SPREAD * abs(one - want) / abs(want))
            for r in ranks:
                got = r[case.name]["metrics"][k][key]
                assert abs(got - want) <= tol * abs(want), (k, key, tol)


def hold_state(ranks, ref, case, strategy=None) -> None:
    """Every leaf of the state after the steps, each rank's block by
    `state_shardings` (`hold`), the step count equal."""
    flat, _, specs = state_specs(case, strategy)
    names = fields(specs)
    assert len(ranks[0][case.name]["state"]) == len(flat)
    for i, (spec, field) in enumerate(zip(flat, names)):
        want = ref[f"{case.name}_state{i}"]
        if field == "step":
            for r in ranks:
                assert int(r[case.name]["state"][i]) == int(want) == \
                    chk.TRAIN_STEPS
            continue
        hold(ranks, lambda r: r[case.name]["state"][i], want,
             ref[f"{case.name}_one_state{i}"], spec,
             f"{case.name} state {field} {i}")


def hold_shapes(ranks, case, strategy=None) -> None:
    """Each rank's block of every state leaf has the shape of its block
    by the reference's `state_shardings`."""
    flat, shapes, _ = state_specs(case, strategy)
    for r in ranks:
        want = [ga.block_shape(spec, tuple(s.shape), r["coords"])
                for spec, s in zip(flat, shapes)]
        assert [tuple(s) for s in r[case.name]["shapes"]] == want
