"""The port's op counter (`repro_torch.workloads.opcounts`: a
`TorchDispatchMode` over the smoke models, plain kernels, on the CPU)
against the JAX package's HLO walk (`repro.workloads.model_opcount`), in
all 20 (arch, phase) cells: the mixes per isa group within 0.05, the
same two hottest F groups (they set the trace's loop structure), the
prefill/decode asymmetry in every arch, and counts that do not depend on
the weights or the tokens.  The cells where the two models run different
algorithms for the same function are named below with their measured
gaps (ROADMAP §3); nothing else is exempt.  Then the charging rules on
small hand-made graphs."""
import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from repro import workloads as JW
from repro.core import isa
from repro.workloads import opcounts as jopc
from repro_torch.workloads import opcounts as topc

NAMES = JW.list_workloads()
ARCHS = sorted({n.rsplit(":", 1)[0] for n in NAMES})
TOL = 0.05

# cell -> {group: measured port - reference gap} for every group past
# the tolerance: the JAX RWKV6 prefill
# runs its chunk-64 WKV form ((B, C, C, H, N) decay tensors, broadcast,
# clamped and exponentiated), the port's plain scan the per-step
# recurrence; the JAX RecurrentGemma prefill cuts local attention into
# two-chunk pairs, the port makes one windowed call over 512-key blocks
GAPS = {"rwkv6-7b:prefill": {"fma": 0.2415, "base": -0.2010},
        "recurrentgemma-9b:prefill": {"base": 0.0552}}
# cell -> (port's, reference's) hottest two F groups: the RWKV6 step
# recurrence multiplies more than it adds (kv, u k v and w s against two
# adds a step); XLA's duplicated token-shift mixes and chunked decays add
# more
TOP2 = {"rwkv6-7b:prefill": (("fma", "fmul"), ("fma", "fadd")),
        "rwkv6-7b:decode": (("fma", "fmul"), ("fma", "fadd"))}


def _frac(oc) -> dict:
    f = oc.frac()
    return {g: float(f[isa.GROUP_ID[g]]) for g in isa.GROUP_NAMES}


def _top2(frac: dict) -> tuple:
    by = sorted(((frac[g], g) for g in isa.F_GROUPS if frac[g] > 0),
                key=lambda t: (-t[0], t[1]))
    return tuple(g for _, g in by[:2])


@pytest.mark.parametrize("name", NAMES)
def test_counter_mix_holds_against_reference(name):
    arch, phase = name.rsplit(":", 1)
    mine = _frac(topc.model_opcount(arch, phase))
    ref = _frac(jopc.model_opcount(arch, phase))
    gaps = {g: mine[g] - ref[g] for g in isa.GROUP_NAMES}
    named = GAPS.get(name, {})
    for g, v in gaps.items():
        if g in named:
            assert abs(v - named[g]) < 5e-4, (name, g, gaps)
        else:
            assert abs(v) <= TOL, (name, g, gaps)
    want = TOP2.get(name, (_top2(ref), _top2(ref)))
    assert (_top2(mine), _top2(ref)) == want, (mine, ref)
    # the spec the registry builds from the port's count is well formed
    assert sum(mine.values()) == pytest.approx(1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_phase_asymmetry(arch):
    pre = _frac(topc.model_opcount(arch, "prefill"))
    dec = _frac(topc.model_opcount(arch, "decode"))
    assert pre["fma"] > dec["fma"], (pre, dec)
    assert dec["base"] > pre["base"], (pre, dec)


@pytest.mark.parametrize("name", NAMES)
def test_counts_do_not_depend_on_weights_or_tokens(name):
    arch, phase = name.rsplit(":", 1)
    base = topc.count_phase(arch, phase).to_dict()
    assert topc.count_phase(arch, phase, weight_seed=7).to_dict() == base
    assert topc.count_phase(arch, phase, token_seed=3).to_dict() == base
    assert topc.model_opcount(arch, phase).to_dict() == base


def test_model_opcount_rejects_unknown_phase_as_reference():
    msgs = []
    for mod in (topc, jopc):
        with pytest.raises(ValueError) as e:
            mod.model_opcount("granite-3-2b", "train")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the charging rules on small graphs
# ---------------------------------------------------------------------------

def _count(fn, *args, resident=()):
    with torch.no_grad(), topc.opcount_from_torch(resident=resident) as c:
        fn(*args)
    return c


def test_contraction_charges_fma_and_crossings():
    a, b = torch.randn(6, 5), torch.randn(5, 3)
    c = _count(torch.mm, a, b)
    assert c.hist == {"dot:f": 2.0 * 6 * 3 * 5}
    assert c.opcount().counts["fma"] == 6 * 3 * 5
    # operands and result cross HBM twice each
    assert c.bytes == 2 * 4 * (30 + 15 + 18)
    # a resident operand is read once
    assert _count(torch.mm, a, b, resident=[b]).bytes == \
        2 * 4 * (30 + 18) + 4 * 15


def test_elementwise_transcendental_and_composite_rules():
    x = torch.randn(4, 8)
    c = _count(torch.exp, x)
    assert c.hist == {"exponential:f": 32.0}
    oc = c.opcount()
    assert oc.counts == {"fma": 128.0, "fdiv": 32.0}
    assert oc.transcendental_elems == 32.0
    c = _count(torch.nn.functional.silu, x)
    assert c.hist == {"negate:f": 32.0, "exponential:f": 32.0,
                      "add:f": 32.0, "divide:f": 32.0, "multiply:f": 32.0}
    assert _count(torch.square, x).hist == {"multiply:f": 32.0}
    # a Python scalar is broadcast to the output
    assert _count(lambda t: t * 0.5, x).hist == \
        {"multiply:f": 32.0, "broadcast:f": 32.0}


def test_select_is_classed_by_its_condition_and_recomputed_per_reader():
    s = torch.randn(2, 16)
    mask = torch.rand(1, 16) > 0.5

    def fn(s, mask):
        w = torch.where(mask, s, -1e30)
        return w.amax(-1), w - 1.0

    h = _count(fn, s, mask).hist
    # the select (base: its bool condition), the mask and the scalar
    # broadcasts, once per reader; amax and subtract on top
    assert h["select:i"] == 2 * 32
    assert h["broadcast:i"] == 2 * 32
    assert h["broadcast:f"] == 2 * 32 + 32       # + the subtract's 1.0
    assert h["maximum:f"] == 2 and h["subtract:f"] == 32
    assert _count(torch.lt, s, 0.0).hist["compare:f"] == 32


def test_views_are_free_and_permuted_reads_transpose():
    x = torch.randn(3, 4, 5)
    assert _count(lambda t: t.view(12, 5)[1:3].unsqueeze(0), x).hist == {}
    c = _count(lambda t: t.permute(2, 0, 1) + 1.0, x)
    assert c.hist["transpose:f"] == 2 * 60 and c.bytes == 2 * 4 * 60
    # data movement is base at its output, read and written
    c = _count(lambda t: torch.cat([t, t], 0), x)
    assert c.hist == {"cat:f": 120.0} and c.bytes == 4 * (60 + 60 + 120)
