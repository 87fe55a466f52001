"""The plain reference against the port on the CPU at a tiny size, and
the benchmark's weights in the port's layout."""
import time

import pytest
import torch

from cardbench import check, run
from cardbench.tests import tiny
from cardbench.tree import flatten


@pytest.mark.parametrize("name", [tiny.TRAIN, tiny.SERVE])
def test_weights_have_the_ports_tree(name):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer
    cell = tiny.cell(name, "bfloat16")
    ours = flatten(cell.reference.draw(cell.model, 5, "cpu"))
    theirs = flatten(transformer.init_params(
        ModelConfig(**cell.model), torch.Generator(), device="meta"))
    assert [(p, t.shape, t.dtype) for p, t in ours] == \
        [(p, t.shape, t.dtype) for p, t in theirs]


def test_weights_repeat_from_the_seed():
    cell = tiny.cell(tiny.SERVE)
    draw = cell.reference.draw
    a = flatten(draw(cell.model, 2 ** 33 + 1, "cpu"))
    b = flatten(draw(cell.model, 2 ** 33 + 1, "cpu"))
    c = flatten(draw(cell.model, 2 ** 33 + 2, "cpu"))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert not torch.equal(a[0][1], c[0][1])


def test_training_reference_follows_the_port():
    """The port's three steps (f32 at this size) and the reference's agree
    to f32 rounding: loss, first gradient and change, leaf by leaf."""
    cell = tiny.cell(tiny.TRAIN)
    out = run.measure(cell, 2 ** 35 + 9, 0.5, 0, "cpu", time.perf_counter())
    assert out["correct"]
    for name, v in out["check"].items():
        assert v["value"] < 1e-5, name


def test_serving_reference_follows_the_port():
    """Prefill, then decoding through the cache, against one causal pass:
    the served tokens are the reference's best (f32 at this size)."""
    cell = tiny.cell(tiny.SERVE)
    out = run.measure(cell, 2 ** 35 + 10, 3.0, 0, "cpu", time.perf_counter())
    assert out["correct"] and out["attempted"] > 0
    assert out["check"]["logit_gap"]["value"] < 1e-4
    assert set(out["metrics"]) == {"output_tokens_per_s", "ttft_p95_ms",
                                   "itl_p95_ms", "setup_s"}


def test_the_reference_follows_the_decode_steps_experts():
    """Where the program took other experts at a decoded position, the
    reference that follows them reads its tokens as its own best, and
    `route_gap` shows how far below the k-th best those experts lie."""
    cell = tiny.cell(tiny.SERVE)
    ref = cell.reference
    m = cell.model
    w = ref.draw(m, 3, "cpu")
    prompt = torch.arange(20) % m["vocab"]
    served = torch.zeros(6, dtype=torch.long)
    own = ref.sequences(m, w, [(prompt, served)], "f32")
    other = own["routes"][0].clone()
    other[:, :, -1] = (other[:, :, -1] + 1) % m["num_experts"]
    other[:, :, -1] = torch.where(other[:, :, -1] == other[:, :, 0],
                                  (other[:, :, -1] + 1) % m["num_experts"],
                                  other[:, :, -1])
    for j in range(len(served)):      # causal: token j reads tokens < j
        logits = ref.sequences(m, w, [(prompt, served)], "f32",
                               [other])["logits"][0]
        served[j] = int(torch.argmax(logits[j]))
    followed = check.serve_gaps(cell, w, [(prompt, served, other)])
    assert followed["positions"] == len(served)
    assert followed["logit_gap"] == 0.0 and followed["route_gap"] > 0
    mine = ref.sequences(m, w, [(prompt, served)], "f32")
    assert check.serve_gaps(
        cell, w, [(prompt, served, mine["routes"][0])])["route_gap"] == 0
    assert check.serve_gaps(cell, w, [(prompt, served, mine["routes"][0])])[
        "logit_gap"] > 1e-3
