"""The plain versions of the port's grouped-FFN kernel
(`repro_torch.kernels.moe_gmm`: `moe_gmm_plain`, `moe_gmm_skip_plain`)
against the JAX package's Pallas kernels in interpret mode (the cases of
test_kernels.py) and against `repro.kernels.ref.moe_gmm_ref`, for the
ragged shapes the Pallas kernels cannot take.  Same numpy inputs into both
packages; tolerances those of test_kernels.py: 2e-5 in f32, 3e-2 in
bf16.  Empty experts of the skip variant are exact zeros."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from repro.kernels import ops, ref
from repro_torch.kernels import moe_gmm as tg

jax.config.update("jax_default_matmul_precision", "float32")

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(seed, e, c, d, f, dtype):
    """x (scaled 0.5) and wg, wi, wo (scaled fan_in^-0.5) as (jax, torch)
    pairs in `dtype`, from one numpy generator."""
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    out = []
    for shape, scale in (((e, c, d), 0.5), ((e, d, f), d ** -0.5),
                         ((e, d, f), d ** -0.5), ((e, f, d), f ** -0.5)):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        out.append((jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)))
    return out


def _close(got: torch.Tensor, want, dtype: str):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("e,c,d,f,gated,dtype", [
    (2, 128, 128, 256, True, "f32"),
    (4, 128, 256, 512, True, "bf16"),
    (2, 128, 128, 128, False, "f32"),
])
def test_plain_matches_pallas_and_ref(e, c, d, f, gated, dtype):
    (jx, x), (jwg, wg), (jwi, wi), (jwo, wo) = _inputs(6, e, c, d, f, dtype)
    want = ops.moe_gmm(jx, jwg, jwi, jwo, gated=gated, block_c=64,
                       block_f=128, block_d=64)
    got = tg.moe_gmm_plain(x, wg, wi, wo, gated=gated)
    assert got.dtype == x.dtype and got.shape == x.shape
    _close(got, want, dtype)
    _close(got, ref.moe_gmm_ref(jx, jwg, jwi, jwo, gated=gated), dtype)


def test_skip_plain_matches_pallas_skip():
    """test_kernels.py's skip case: live experts equal the Pallas skip
    kernel (and ref), empty experts are exact zeros."""
    (jx, x), (jwg, wg), (jwi, wi), (jwo, wo) = _inputs(8, 4, 64, 64, 128,
                                                       "f32")
    counts = np.array([5, 0, 3, 0], np.int32)
    want = ops.moe_gmm_skip(jx, jwg, jwi, jwo, jnp.asarray(counts),
                            block_c=64, block_f=64, block_d=64)
    got = tg.moe_gmm_skip_plain(x, wg, wi, wo, torch.from_numpy(counts))
    full = ref.moe_gmm_ref(jx, jwg, jwi, jwo)
    for i, n in enumerate(counts):
        if n > 0:
            _close(got[i], want[i], "f32")
            _close(got[i], full[i], "f32")
        else:
            assert not got[i].any() and not np.asarray(want[i]).any()


@pytest.mark.parametrize("c", [8, 16, 32])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_pallas_at_path_capacities(c, dtype):
    """The capacities of the model path (C 8 at a decode step, up to 32 at
    a prefill) at a narrow width: both plain versions against the Pallas
    kernels in interpret mode, with counts holding zeros."""
    (jx, x), (jwg, wg), (jwi, wi), (jwo, wo) = _inputs(10 + c, 4, c, 128,
                                                       256, dtype)
    want = ops.moe_gmm(jx, jwg, jwi, jwo, block_c=c, block_f=128,
                       block_d=64)
    _close(tg.moe_gmm_plain(x, wg, wi, wo), want, dtype)
    counts = np.array([0, c, 0, 1], np.int32)
    want = ops.moe_gmm_skip(jx, jwg, jwi, jwo, jnp.asarray(counts),
                            block_c=c, block_f=128, block_d=64)
    got = tg.moe_gmm_skip_plain(x, wg, wi, wo, torch.from_numpy(counts))
    _close(got, want, dtype)
    for i, n in enumerate(counts):
        if n == 0:
            assert not got[i].any() and not np.asarray(want[i]).any()


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ragged_shapes_match_ref(gated, dtype):
    """Shapes no Pallas block divides (E 3, C 24, D 96, F 80), against
    ref only; the skip variant on the same inputs."""
    (jx, x), (jwg, wg), (jwi, wi), (jwo, wo) = _inputs(9, 3, 24, 96, 80,
                                                       dtype)
    want = ref.moe_gmm_ref(jx, jwg, jwi, jwo, gated=gated)
    _close(tg.moe_gmm_plain(x, wg, wi, wo, gated=gated), want, dtype)
    counts = torch.tensor([0, 7, 0], dtype=torch.int32)
    got = tg.moe_gmm_skip_plain(x, wg, wi, wo, counts, gated=gated)
    _close(got[1], want[1], dtype)
    assert not got[0].any() and not got[2].any()


def test_ungated_reads_wg_not_wi():
    """As the Pallas kernel: gelu(x @ wg) @ wo, with wi never read."""
    (_, x), (_, wg), (_, wi), (_, wo) = _inputs(3, 2, 8, 16, 24, "f32")
    want = tg.moe_gmm_plain(x, wg, wi, wo, gated=False)
    assert torch.equal(tg.moe_gmm_plain(x, wg, None, wo, gated=False), want)
    assert torch.equal(tg.moe_gmm_plain(x, wg, wi * 7, wo, gated=False),
                       want)


def test_wrappers_run_plain_on_cpu_tensors():
    (_, x), (_, wg), (_, wi), (_, wo) = _inputs(4, 3, 8, 16, 24, "f32")
    counts = torch.tensor([2, 0, 1], dtype=torch.int32)
    before = (tg.moe_gmm.launches, tg.moe_gmm_skip.launches)
    assert torch.equal(tg.moe_gmm(x, wg, wi, wo),
                       tg.moe_gmm_plain(x, wg, wi, wo))
    assert torch.equal(tg.moe_gmm_skip(x, wg, wi, wo, counts),
                       tg.moe_gmm_skip_plain(x, wg, wi, wo, counts))
    assert (tg.moe_gmm.launches, tg.moe_gmm_skip.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        tg.moe_gmm(x, wg, wi, wo, use_kernel="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tg.moe_gmm_skip(x, wg, wi, wo, counts, use_kernel=True)
