"""Serving under the reference's GSPMD layouts, one process a rank: one job
of 4 gloo ranks (`torch_gspmd_checks.run_ranks`) serves the smoke configs
of the eight attention archs (`torch_gspmd_checks.ARCHS`): granite-3-2b
(head-TP, FSDP), qwen1.5-4b (sequence-parallel), arctic-480b
(sequence-parallel with experts and the dense residual, FSDP),
minitron-4b (sequence-parallel, GQA), llama4-maverick-400b-a17b
(attention and top-1 MoE blocks, FSDP), qwen1.5-110b (head-TP with qkv
biases, FSDP), musicgen-medium (embeddings in) and qwen2-vl-7b
(embeddings and mrope positions in) through `repro_torch.serve.step` on
a (data 2, model 2) mesh, while one JAX subprocess on 4 forced host
devices runs the reference's `repro.serve.step` under its plans
(`jax_gspmd_reference.py`).  Every rank's blocks are held
(`gspmd_asserts`)

* within 1e-5 relative L2 (f32): `jit_prefill_step`'s logits and cache,
  `jit_decode_step`'s logits over 3 steps and the final cache; the
  expert loads equal;
* to the reference's specs (`repro.sharding.partition.ShardingPlan` on
  the mesh's shape): each weight leaf a rank holds has the shape of its
  block by `param_specs`, each tagged activation that of its block by
  `act_spec` fitted to its global shape, recorded by wrapping `act`;
* flash on head shards (head-TP: H/2 local heads) and on sequence
  shards (sequence-parallel: the second sequence block at `q_offset`
  T/2);

and `model_batcher` under a plan serves every request's tokens as the
one-rank batcher does.  `Mesh.reduce_scatter` sums over its axes.  The
plain flash takes the reference's `q_offset`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gspmd_asserts as ga
import torch_asserts  # noqa: F401  (one torch thread under xdist)
import torch_gspmd_checks as chk
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tfa

jax.config.update("jax_default_matmul_precision", "float32")

FLASH_TOL = 2e-5
CASES = pytest.mark.parametrize("case", chk.ARCHS,
                                ids=[c.name for c in chk.ARCHS])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' outputs in rank order, the reference's arrays)."""
    return ga.run_job(tmp_path_factory, chk.ARCHS, chk.SERVE_ARCHS)


@CASES
def test_prefill_step_matches_jax_serve_step(run, case):
    ga.hold_prefill(run, case)


@CASES
def test_decode_steps_match_jax_serve_step(run, case):
    ga.hold_decode(run, case)


@CASES
def test_each_rank_holds_its_blocks_of_the_weights(run, case):
    ga.hold_weights(run, case)


@CASES
def test_tagged_activations_have_their_blocks_shapes(run, case):
    ga.hold_acts(run, case)


@CASES
def test_flash_runs_on_head_or_sequence_shards(run, case):
    """Head-TP (granite, qwen1.5-110b): each rank's flash calls take H/2
    query heads at offset 0; sequence-parallel (the others): all H
    heads, the second model rank's queries at q_offset T0/2; no
    window."""
    ranks, _ = run
    cfg = ga.jconfig(case)
    for r in ranks:
        calls = r[case.name]["flash"]
        assert len(calls) == cfg.num_layers
        if cfg.attn_sharding == "heads":
            want = (cfg.num_heads // 2, 0, 0)
        else:
            want = (cfg.num_heads, r["coords"]["model"] * case.t0 // 2, 0)
        assert set(calls) == {want}


@pytest.mark.parametrize("arch", chk.SERVE_ARCHS)
def test_model_batcher_under_a_plan_serves_as_one_rank(run, arch):
    ga.hold_serve(run, arch)


def test_reduce_scatter_sums_over_its_axes(run):
    ranks, _ = run
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    for r in ranks:
        d, m = r["coords"]["data"], r["coords"]["model"]
        # the model group of data row d: ranks 2d and 2d + 1
        want = x[:, 3 * m:3 * m + 3] * (4 * d + 3)
        np.testing.assert_array_equal(r["reduce_scatter"]["model"].numpy(),
                                      want)
        np.testing.assert_array_equal(r["reduce_scatter"]["both"].numpy(),
                                      x[r["rank"]:r["rank"] + 1] * 10)


@pytest.mark.parametrize("tq,tk,h,kh,q_offset,window", [
    (64, 64, 4, 2, 0, 0),            # a whole prompt
    (32, 64, 4, 2, 32, 0),           # the second sequence block of two
    (32, 64, 4, 4, 32, 24),          # ... with a window
    (16, 64, 8, 2, 48, 0),           # the last block of four, GQA 4
])
def test_flash_plain_takes_the_references_q_offset(tq, tk, h, kh, q_offset,
                                                   window):
    """The plain flash on a block of queries at their global positions
    against the whole K/V equals the reference's
    `layers.flash_attention(q_offset=...)` within 2e-5 (f32), in blocks
    smaller than the keys."""
    rng = np.random.default_rng(q_offset + window)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
        (2, tq, h, 16), (2, tk, kh, 16), (2, tk, kh, 16)))
    want = jlayers.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, block=16, q_offset=q_offset)
    got = tfa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window, block=16, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FLASH_TOL, rtol=FLASH_TOL)
    # the kernel's count of the pairs it attends
    pos = q_offset + np.arange(tq)[:, None]
    kpos = np.arange(tk)[None, :]
    seen = (kpos <= pos) & ((kpos > pos - window) if window else True)
    assert tfa.visible_pairs(tq, tk, True, window, q_offset) == seen.sum()
