"""The frozen work counts: hand counts at small shapes, and (here only)
the port's own kernel `cost` at today's shapes."""
import pytest

from cardbench import spec
from cardbench.work import flops, kernels, peaks

SMALL = {"num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 1,
         "head_dim": 4, "d_ff": 16, "vocab": 10, "mlp": "swiglu"}


def test_dense_counts_by_hand():
    attn = 8 * (2 + 2 * 1) * 4 + 2 * 4 * 8          # wq wk wv + wo
    mlp = 3 * 8 * 16
    assert flops.layer_params_per_token(SMALL) == attn + mlp
    tokens, pairs = 3 * 5, 3 * 15                   # 3 rows of 5: 15 pairs
    per_pair = 4 * 2 * 4 * 2                        # 4 H Dh, 2 layers
    want = 6 * (2 * (attn + mlp) + 8 * 10) * tokens + 3 * pairs * per_pair
    assert flops.train_step(SMALL, 3, 5) == want
    assert flops.prefill(SMALL, 5) == 2 * (2 * (attn + mlp) * 5 + 80) + \
        15 * per_pair
    assert flops.decode_token(SMALL, 4) == 2 * (2 * (attn + mlp) + 80) + \
        5 * per_pair


def test_moe_counts_by_hand():
    m = dict(SMALL, num_experts=4, top_k=2, dense_ff_residual=6)
    attn = 8 * 16 + 64
    want = attn + 8 * 4 + 2 * 3 * 8 * 16 + 3 * 8 * 6
    assert flops.layer_params_per_token(m) == want


def test_granite_step_count():
    m = spec.cell("granite-3-2b.train-4x1024").model
    params = 40 * flops.layer_params_per_token(m) + 2048 * 49155
    assert 6 * params * 4096 == pytest.approx(6.2260e13, rel=1e-4)
    assert flops.train_step(m, 4, 1024) == pytest.approx(
        6 * params * 4096 + 3 * 4 * 524_800 * 4 * 32 * 64 * 40)


def test_least_times_by_hand():
    assert kernels.least(989e12, 0) == pytest.approx(1.0)
    assert kernels.least(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES == 3.35e12


@pytest.mark.parametrize("b,t,h,kh,dh", [(4, 1024, 32, 8, 64),
                                        (1, 4064, 56, 8, 128)])
def test_flash_least_time_is_the_ports_cost(b, t, h, kh, dh):
    import torch
    from repro_torch.kernels import flash_attention
    c = flash_attention.cost(b, t, t, h, kh, dh, torch.bfloat16)
    flops_, nbytes = c["flops"]["bf16"], c["bytes"]
    assert kernels.flash_forward(b, t, h, kh, dh) == pytest.approx(
        kernels.least(flops_, nbytes))


@pytest.mark.parametrize("rows,live", [(5000, 128), (16, 12)])
def test_moe_least_time_against_the_ports_cost(rows, live):
    import torch
    from repro_torch.kernels import moe_gmm
    # the port counts C rows a live expert; with rows spread evenly its
    # count is the same work as `rows` routed rows
    c = moe_gmm.cost(live, 128, rows // live, 7168, 4864, torch.bfloat16)
    ours = kernels.moe_ffn(live * (rows // live), live, 7168, 4864)
    assert ours <= kernels.least(c["flops"]["bf16"], c["bytes"]) * 1.0001
    assert ours == pytest.approx(kernels.least(
        c["flops"]["bf16"], c["bytes"]), rel=0.05)
