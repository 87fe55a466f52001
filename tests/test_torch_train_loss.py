"""The port's training loss (`repro_torch.models.transformer.loss_fn`)
and its gradients against `jax.value_and_grad` of the JAX package's
`repro.models.transformer.loss_fn`, in f32 on the CPU.

One smoke arch of each family: granite (dense), arctic (MoE),
recurrentgemma (RG-LRU + local attention), rwkv6, musicgen (embeddings
in, labels) and qwen2-vl (M-RoPE positions), on the JAX package's own
smoke weights (`init_params(PRNGKey(0))`) carried across as numpy, the
same inputs in both.  The smoke configs turn remat and the chunked vocab
loss off, so each case replaces both fields, in both packages: remat in
{none, full, dots} and loss_chunk in {0, T/2}.  The loss and every
gradient leaf agree within TOL = 1e-4 of `tests/test_torch_model.py` (f32
rounding of different summation orders over 2 or 3 layers)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from repro.configs import base as jcb
from repro.models import transformer as jt
from repro_torch.configs import base as tcb
from repro_torch.models import convert
from repro_torch.models import transformer as tt
from repro_torch.tree_util import leaves, leaves_with_paths

jax.config.update("jax_default_matmul_precision", "float32")
jcb.load_all()
tcb.load_all()

ARCHS = ["granite-3-2b", "arctic-480b", "recurrentgemma-9b", "rwkv6-7b",
         "musicgen-medium", "qwen2-vl-7b"]
TOL = 1e-4
B, T = 2, 16


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.embed_inputs:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    else:
        batch["embeds"] = rng.standard_normal((B, T, cfg.d_model)).astype(
            np.float32)
        batch["labels"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    if cfg.pos == "mrope":
        batch["positions"] = (np.arange(T)[None, :, None] + rng.integers(
            0, 3, (B, 1, 3))).astype(np.int32)
    return batch


@pytest.mark.parametrize("loss_chunk", [0, T // 2])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch, remat, loss_chunk):
    kw = dict(remat=remat, loss_chunk=loss_chunk)
    jcfg = dataclasses.replace(jcb.get_config(arch).smoke(), **kw)
    tcfg = dataclasses.replace(tcb.get_config(arch).smoke(), **kw)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jt.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
        has_aux=True)(jparams)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, aux = tt.loss_fn(tcfg, params, batch)
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL, atol=TOL)
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(want)
    for (path, _), g, w in zip(leaves_with_paths(params), grads, want,
                               strict=True):
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=str(path))
    if tcfg.is_moe:
        loads = [a["expert_load"] for seg in aux for a in seg
                 if "expert_load" in a]
        assert loads and all(int(x.sum()) == B * T * tcfg.top_k
                             for load in loads for x in load)
