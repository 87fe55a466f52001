"""The plain versions of the port's two attention kernels
(`repro_torch.kernels.flash_attention` / `decode_attention`) against the
JAX package's Pallas kernels in interpret mode (the shape sweep of
test_kernels.py) and against `repro.kernels.ref` for the ragged lengths
the Pallas kernels cannot take.  Same numpy inputs into both packages;
tolerances those of test_kernels.py: 2e-5 in f32, 2e-2 in bf16."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from repro.kernels import ops, ref
from repro.models import layers
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa

jax.config.update("jax_default_matmul_precision", "float32")

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, shapes, dtype):
    """Standard-normal numpy arrays, as (jax, torch) pairs in `dtype`."""
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    out = []
    for shape in shapes:
        x = rng.standard_normal(shape).astype(np.float32)
        out.append((jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)))
    return out


def _close(got: torch.Tensor, want, dtype: str):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,tq,tk,h,kh,dh,dtype", [
    (1, 128, 128, 2, 2, 64, "f32"),
    (2, 256, 256, 4, 2, 64, "f32"),
    (1, 128, 128, 4, 1, 128, "bf16"),   # MQA
    (2, 64, 64, 2, 2, 32, "f32"),
    (1, 128, 128, 8, 2, 64, "bf16"),    # GQA g=4, the granite group
])
def test_flash_plain_matches_pallas(b, tq, tk, h, kh, dh, dtype):
    (jq, q), (jk, k), (jv, v) = _inputs(
        0, [(b, tq, h, dh), (b, tk, kh, dh), (b, tk, kh, dh)], dtype)
    want = ops.flash_attention(jq, jk, jv, block_q=64, block_kv=64)
    _close(tfa.flash_attention_plain(q, k, v), want, dtype)
    _close(tfa.flash_attention_plain(q, k, v, block=64), want, dtype)


@pytest.mark.parametrize("causal,window", [(True, 64), (False, 0)])
def test_flash_plain_window_and_noncausal_match_pallas(causal, window):
    (jq, q), (jk, k), (jv, v) = _inputs(
        1, [(1, 256, 2, 64), (1, 256, 2, 64), (1, 256, 2, 64)], "f32")
    want = ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                               block_q=64, block_kv=64)
    got = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    _close(got, want, "f32")


@pytest.mark.parametrize("t,h,kh,dh,window,dtype", [
    (1, 32, 8, 64, 0, "f32"),
    (63, 8, 2, 64, 0, "f32"),
    (65, 4, 4, 128, 0, "bf16"),
    (100, 8, 1, 64, 0, "f32"),          # MQA
    (97, 4, 2, 64, 24, "f32"),          # windowed, ragged
    (130, 8, 2, 128, 0, "bf16"),
])
def test_flash_plain_ragged_matches_ref(t, h, kh, dh, window, dtype):
    """Lengths that are no multiple of a block: the Pallas kernel asserts
    them away, the batcher prefills them."""
    (jq, q), (jk, k), (jv, v) = _inputs(
        2, [(2, t, h, dh), (2, t, kh, dh), (2, t, kh, dh)], dtype)
    want = ref.flash_attention_ref(jq, jk, jv, window=window)
    _close(tfa.flash_attention_plain(q, k, v, window=window, block=64),
           want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_plain_keyless_rows_match_jax_layers(dtype):
    """Tq 300 over Tk 100 with a 50-key window: rows 149 and later see no
    key.  The plain version keeps JAX's block scan there (a mean over the
    zero-padded 512-key block, where the port's kernel gives 0), and
    equals it on every row."""
    (jq, q), (jk, k), (jv, v) = _inputs(
        4, [(1, 300, 2, 64), (1, 100, 1, 64), (1, 100, 1, 64)], dtype)
    want = np.asarray(layers.flash_attention(jq, jk, jv, causal=True,
                                             window=50), np.float32)
    got = tfa.flash_attention_plain(q, k, v, causal=True, window=50)
    _close(got, want, dtype)
    mean = v.float().sum(1, keepdim=True) / 512
    _close(got[:, 149:], mean.expand(1, 151, 2, 64), dtype)


def test_flash_wrapper_runs_plain_on_cpu_and_refuses_the_kernel():
    (_, q), (_, k), (_, v) = _inputs(
        3, [(1, 16, 4, 64), (1, 16, 2, 64), (1, 16, 2, 64)], "f32")
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v)
    assert torch.equal(got, tfa.flash_attention_plain(q, k, v))
    assert torch.equal(tfa.flash_attention(q, k, v, use_kernel="plain"),
                       got)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k, v, use_kernel="kernel")
    with pytest.raises(ValueError, match="use_kernel"):
        tfa.flash_attention(q, k, v, use_kernel="bogus")
    assert tfa.flash_attention.launches == before


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,kh,dh,dtype", [
    (2, 512, 4, 2, 64, "f32"),
    (1, 1024, 8, 1, 128, "bf16"),
    (3, 256, 2, 2, 32, "f32"),
    (4, 512, 32, 8, 64, "bf16"),        # the granite group
])
def test_decode_plain_matches_pallas(b, s, h, kh, dh, dtype):
    (jq, q), (jk, kc), (jv, vc) = _inputs(
        4, [(b, h, dh), (b, s, kh, dh), (b, s, kh, dh)], dtype)
    lens = np.array([s // 2 + 7 * i for i in range(b)], np.int32)
    want = ops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_kv=128)
    _close(tda.decode_attention_plain(q, kc, vc, torch.from_numpy(lens)),
           want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_plain_kv_len_edges_match_pallas(dtype):
    """kv_len 0 (every block skipped: zeros), 1, S and ragged, against the
    Pallas kernel itself."""
    b, s, h, kh, dh = 5, 256, 8, 2, 64
    (jq, q), (jk, kc), (jv, vc) = _inputs(
        5, [(b, h, dh), (b, s, kh, dh), (b, s, kh, dh)], dtype)
    lens = np.array([0, 1, s, 129, 200], np.int32)
    want = ops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_kv=128)
    got = tda.decode_attention_plain(q, kc, vc, torch.from_numpy(lens))
    _close(got, want, dtype)
    assert not got[0].any(), "kv_len == 0 gives zeros, as the Pallas kernel"


def test_decode_kv_len_zero_diverges_from_ref():
    """`ref.decode_attention_ref` averages v over an all-masked row; the
    Pallas kernel (and the port) give 0.  The model path never has
    kv_len == 0."""
    (jq, q), (jk, kc), (jv, vc) = _inputs(
        6, [(1, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)], "f32")
    lens = np.zeros((1,), np.int32)
    r = np.asarray(ref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)))
    np.testing.assert_allclose(
        r[0, 0], np.asarray(jv, np.float32)[0, :, 0].mean(0), atol=1e-5)
    got = tda.decode_attention_plain(q, kc, vc, torch.from_numpy(lens))
    assert not got.any()


@pytest.mark.parametrize("s,lens", [(100, [1, 37, 100]), (33, [33, 5, 17])])
def test_decode_plain_ragged_cache_matches_ref(s, lens):
    """Cache lengths that are no multiple of a block (Pallas asserts)."""
    b = len(lens)
    (jq, q), (jk, kc), (jv, vc) = _inputs(
        7, [(b, 8, 64), (b, s, 2, 64), (b, s, 2, 64)], "f32")
    lens = np.array(lens, np.int32)
    want = ref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens))
    _close(tda.decode_attention_plain(q, kc, vc, torch.from_numpy(lens)),
           want, "f32")


def test_decode_wrapper_runs_plain_on_cpu_and_refuses_the_kernel():
    (_, q), (_, kc), (_, vc) = _inputs(
        8, [(2, 4, 64), (2, 32, 2, 64), (2, 32, 2, 64)], "f32")
    lens = torch.tensor([3, 32], dtype=torch.int32)
    before = tda.decode_attention.launches
    got = tda.decode_attention(q, kc, vc, lens)
    assert torch.equal(got, tda.decode_attention_plain(q, kc, vc, lens))
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention(q, kc, vc, lens, use_kernel="kernel")
    assert tda.decode_attention.launches == before


# ---------------------------------------------------------------------------
# the decode kernel's split-KV arithmetic
# ---------------------------------------------------------------------------

def _edge_lens(s, chunk, b, first_split_only=False):
    """kv_len at and beside the tile (64) and split edges, cycled to b
    rows; with `first_split_only`, only lengths inside the first split
    (every other split empty)."""
    edges = [0, 1, 63, 64, 65, 127, 128, 129, chunk - 1, chunk, chunk + 1,
             2 * chunk - 1, 2 * chunk, 2 * chunk + 1, s - 1, s]
    top = chunk if first_split_only else s
    edges = sorted({e for e in edges if 0 <= e <= top})
    return np.array([edges[i % len(edges)] for i in range(b)], np.int32)


@pytest.mark.parametrize("b,s,h,kh,dh,dtype,first_only", [
    (1, 512, 4, 1, 64, "f32", False),     # B x KH 1: 8 one-tile splits
    (4, 512, 8, 2, 64, "bf16", False),    # B x KH 8
    (8, 1024, 16, 1, 64, "f32", False),   # recurrentgemma's B 8 x KH 1
    (8, 1024, 16, 1, 64, "bf16", True),   # ... every split but one empty
    (8, 512, 32, 8, 64, "bf16", False),   # granite's B 8 x KH 8 = 64
    (16, 512, 8, 4, 64, "f32", True),     # B x KH 64, one-tile splits
])
def test_decode_split_plain_matches_pallas_at_split_edges(b, s, h, kh, dh,
                                                          dtype, first_only):
    """The decode kernel's split-and-merge arithmetic in plain PyTorch
    (`split_plan`'s ranges, a partial (m, l, acc) each, the merge) against
    the Pallas kernel in interpret mode and the plain version, with
    kv_len at 64 k, 64 k +- 1 and the split edges; kv_len 0 gives exact
    zeros, as the Pallas kernel does."""
    splits, chunk = tda.split_plan(b, kh, s)
    lens = _edge_lens(s, chunk, b, first_only)
    (jq, q), (jk, kc), (jv, vc) = _inputs(
        9, [(b, h, dh), (b, s, kh, dh), (b, s, kh, dh)], dtype)
    want = ops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_kv=128)
    got = tda.decode_attention_split_plain(q, kc, vc, torch.from_numpy(lens))
    _close(got, want, dtype)
    _close(got, tda.decode_attention_plain(q, kc, vc, torch.from_numpy(lens))
           .float(), dtype)
    for i, n in enumerate(lens):
        if n == 0:
            assert not got[i].any(), "kv_len == 0 gives zeros"


@pytest.mark.parametrize("s,lens", [(100, [1, 37, 100]), (33, [33, 5, 0])])
def test_decode_split_plain_ragged_cache_matches_ref(s, lens):
    """Cache lengths that are no multiple of a tile (Pallas asserts)."""
    b = len(lens)
    (jq, q), (jk, kc), (jv, vc) = _inputs(
        10, [(b, 8, 64), (b, s, 2, 64), (b, s, 2, 64)], "f32")
    lens = np.array(lens, np.int32)
    want = np.array(ref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)))
    want[lens == 0] = 0.0          # the Pallas kernel's (and the port's) 0
    _close(tda.decode_attention_split_plain(q, kc, vc,
                                            torch.from_numpy(lens)),
           want, "f32")


def test_split_plan_reads_the_shapes_only(monkeypatch):
    """The split rule takes (B, KH, S) as ints, never a tensor: the host
    never reads kv_len (a decode step would synchronise on it).  Its
    splits cover the cache in whole 64-position tiles, the last one
    non-empty, with at least two CTAs an SM where the cache allows."""
    assert tda.split_plan(8, 1, 2048) == (32, 64)     # recurrentgemma
    assert tda.split_plan(8, 8, 2048) == (6, 384)     # granite
    for b, kh, s in [(1, 1, 1), (1, 1, 100), (64, 1, 4096), (3, 7, 333),
                     (16, 4, 1000), (1, 1, 1 << 16)]:
        splits, chunk = tda.split_plan(b, kh, s)
        assert chunk % 64 == 0 and (splits - 1) * chunk < s <= splits * chunk
        assert b * kh * splits >= min(2 * 132, b * kh * -(-s // 64))
    with pytest.raises(TypeError, match="int shapes"):
        tda.split_plan(8, 1, torch.tensor(2048))

    def refuse(*_a, **_k):
        raise AssertionError("a tensor value was read on the host")

    for name in ("item", "tolist", "numpy", "__int__", "__index__",
                 "__bool__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    (_, q), (_, kc), (_, vc) = _inputs(
        11, [(4, 8, 64), (4, 300, 2, 64), (4, 300, 2, 64)], "f32")
    kv_len = torch.full((4,), 77, dtype=torch.int32)
    splits, chunk, part = tda.scratch(q, 300, 2)
    assert (splits, chunk) == tda.split_plan(4, 2, 300)
    assert part.numel() == 4 * 8 * splits * (64 + 2)
    tda.decode_attention_split_plain(q, kc, vc, kv_len)
