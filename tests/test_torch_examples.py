"""The port's examples (`repro_torch.examples`) against the JAX package's
`examples/` on the CPU: every printed line equal as text, after the
port's first line (the config it ran, which the smoke-config rule adds).

The paper figures run at the reduced sizes of test_torch_bench.py in
both packages.  The serve examples run at their own sizes; where a line
comes from a model the two packages share its inputs: serve_models' mix
table is lowered from the JAX package's `OpCount`s (the port's counter is
held to them within 0.05 a group in test_torch_opcounts.py), and the
slot-engine examples serve the JAX package's smoke weights, carried over
by `convert.params_from_numpy`.  Two lines are the port's own:
serve_models' mix header names the port's counted smoke steps where the
JAX example names XLA's compiled HLO, and serve_multitenant's admission
header names `repro_torch.sched` where the JAX example names
`repro.sched`."""
import dataclasses

import jax
import numpy as np
import pytest

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from benchmarks import fig6_single as j_fig6
from benchmarks import fig7_multi as j_fig7
from examples import paper_repro as j_paper
from examples import serve_faulty as j_faulty
from examples import serve_models as j_models
from examples import serve_multitenant as j_multi
from examples import serve_online as j_online
from repro.configs import base as jcb
from repro.models import transformer as jtransformer
from repro.workloads import opcounts as jopc
from repro_torch import examples
from repro_torch import workloads as TW
from repro_torch.bench import fig6_single as t_fig6
from repro_torch.bench import fig7_multi as t_fig7
from repro_torch.configs import base as cb
from repro_torch.examples import paper_repro as t_paper
from repro_torch.examples import serve_faulty as t_faulty
from repro_torch.examples import serve_models as t_models
from repro_torch.examples import serve_multitenant as t_multi
from repro_torch.examples import serve_online as t_online
from repro_torch.models import convert
from repro_torch.workloads import opcounts as topc
from torch_asserts import DEV

CPU = ["--device", DEV]
LLAMA4 = "llama4-maverick-400b-a17b"


def _jax_lines(main, capsys) -> list[str]:
    capsys.readouterr()
    main()
    return capsys.readouterr().out.splitlines()


def _port_lines(main, **kw) -> list[str]:
    lines: list[str] = []
    main(CPU, print_fn=lines.append, **kw)
    return lines


def _smoke_params(arch: str):
    """The JAX package's smoke weights of `arch` from PRNGKey(0), as the
    JAX example draws them, carried to the port."""
    jcb.load_all()
    params = jtransformer.init_params(jcb.get_config(arch).smoke(),
                                      jax.random.PRNGKey(0))
    return convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), DEV)


def test_paper_repro_lines_equal(monkeypatch, capsys):
    for mod in (j_fig6, t_fig6):
        monkeypatch.setattr(mod, "TRACE_LEN", 3_000)
    monkeypatch.setattr(j_fig7, "TRACE_LEN", 3_000)
    monkeypatch.setattr(j_fig7, "TOTAL_STEPS", 20_000)
    monkeypatch.setattr(t_fig7.run, "__kwdefaults__", dict(
        t_fig7.run.__kwdefaults__, trace_len=3_000, total_steps=20_000))
    want = _jax_lines(j_paper.main, capsys)
    got = _port_lines(t_paper.main)
    assert got == want
    assert sum(line.startswith("  AVERAGE") for line in got) > 10


def test_serve_models_lines_equal(monkeypatch, capsys):
    cache = {(arch, phase): topc.OpCount.from_dict(
        jopc.model_opcount(arch, phase).to_dict())
        for arch, phase in (n.split(":") for n in j_models.FLEET.values())}
    monkeypatch.setattr(topc, "_CACHE", cache)
    monkeypatch.setattr(TW, "_SPECS", {})
    want = _jax_lines(j_models.main, capsys)
    got = _port_lines(t_models.main)
    assert want[0] == ("-- instruction mixes from compiled HLO (fraction "
                       "per group) --")
    assert got[0] == ("-- instruction mixes from the counted smoke steps "
                      "(fraction per group) --")
    assert got[1:] == want[1:]


@pytest.mark.parametrize("name", ["serve_multitenant", "serve_online",
                                  "serve_faulty"])
def test_slot_engine_examples_lines_equal(name, capsys):
    j_mod, t_mod = {"serve_multitenant": (j_multi, t_multi),
                    "serve_online": (j_online, t_online),
                    "serve_faulty": (j_faulty, t_faulty)}[name]
    want = _jax_lines(j_mod.main, capsys)
    got = _port_lines(t_mod.main, params=_smoke_params(LLAMA4))
    assert got[0] == examples.config_line(
        cb.get_config(LLAMA4).smoke(), DEV)
    header = "-- contention-aware admission ({}) --"
    assert got[1:] == [header.format("repro_torch.sched")
                       if line == header.format("repro.sched") else line
                       for line in want]


@pytest.mark.parametrize("arch", ["granite-3-2b", LLAMA4])
def test_smoke_config_rule(arch):
    """On the CPU the JAX example's smoke config exactly; on the card head
    dim 64 and every other field unchanged."""
    smoke = cb.get_config(arch).smoke()
    assert examples.smoke_config(arch, "cpu") == smoke
    card = examples.smoke_config(arch, "cuda")
    assert card.head_dim == examples.CARD_HEAD_DIM == 64
    assert dataclasses.replace(card, head_dim=smoke.head_dim) == smoke
    assert cb.get_config(card.name) is card
