"""Card-only checks of the port's CUDA kernels against their plain
PyTorch versions: the window kernel bit for bit on both its routes
("bitset" up to 32 tags, "generic" above; each launch's route counted, the
bitset route's trips and passes equal to its plain model's), plus the sweep
and resume paths that launch it; the flash and decode attention kernels within the
tolerances of test_kernels.py (2e-5 in f32, 2e-2 in bf16), plus the model
path that launches them, and both flash routes' exact zeros on rows
that see no key; the grouped-FFN kernel (`moe_gmm`, `moe_gmm_skip`)
within test_kernels.py's 2e-5 / 3e-2 on both routes (the tensor-core
route at every capacity and at arctic's widths, the route chosen by
dtype, shape and alignment), empty experts exact zeros whose weights are
never read, no host synchronisation, plus the MoE model path; the RG-LRU scan within
test_kernels.py's 2e-5 and the WKV scan within its 5e-4 (bf16 inputs are
widened exactly, so the same tolerances hold), from zero and from given
states, on both kernel routes ("chunked" and "step") at ragged T and at
strong decay, the route each wrapper picks and counts, plus the recurrent
models' paths; the attention kernels at
RecurrentGemma's head dim 256 with 16 query heads over 1; and one online
serve of `repro_torch.sched` under a fault storm on the card against the
same serve on the CPU; the `window_kernel` bench with the real kernel,
two `perf_sweep` sections at a small size, and `model_serve_study`'s P=2
case against the CPU's on the same mixes.  Marked `cuda`;
every test skips without a CUDA device.  On a machine with a card:
`PYTHONPATH=src python -m pytest -q -m cuda tests/`.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as cb
from repro_torch.core import isa, simulator
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm as gmm
from repro_torch.kernels import rglru_scan as rgs
from repro_torch.kernels import rwkv6_scan as rws
from repro_torch.kernels import window_distance as wd
from repro_torch.models import transformer

pytestmark = pytest.mark.cuda

QUANTUM_MENU = (6, 37, 120, 1 << 30)
WINDOWS = (1, 13, 31, 32, 33, 64, 200, 256, 257, 512, 2048)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(rng, p, num_tags, trace_len, dev):
    tags = rng.integers(-1, num_tags, (p, trace_len)).astype(np.int32)
    costs = rng.integers(0, 9, (p, trace_len)).astype(np.int32)
    quanta = np.array([QUANTUM_MENU[i] for i in rng.integers(0, 4, p)],
                      np.int32)
    sched = np.array(list(range(p)) + [0], np.int32)
    t = lambda x: torch.as_tensor(x, device=dev)
    return t(tags), t(costs), t(quanta), t(sched)


def _seed(rng, p, num_tags, trace_len, dev):
    t = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=dev)
    return (t(rng.permutation(num_tags) - 1),
            t(rng.integers(0, 3 * trace_len, p)), t(rng.integers(0, p + 1)),
            t(rng.integers(0, 6)), t(rng.integers(0, 9_000, p)),
            t(rng.integers(0, 900, p)), t(rng.integers(0, 900, p)),
            t(rng.integers(0, 90, p)), t(rng.integers(0, 40)))


@pytest.mark.parametrize("num_tags", (7, 29))
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("mode", ("unseeded", "seeded", "materialise"))
def test_window_cell_kernel_matches_plain(dev, num_tags, window, mode):
    rng = np.random.default_rng(window * 31 + num_tags)
    p = 3
    tags, costs, quanta, sched = _case(rng, p, num_tags, 300, dev)
    seed = (_seed(rng, p, num_tags, 300, dev) if mode == "seeded"
            else None)
    kw = dict(num_tags=num_tags, total_steps=2_500, window=window,
              materialise=mode != "unseeded")
    args = (tags, costs, 3, 41, quanta, sched, 9, 17, seed)
    before = wd.window_cell.launches
    got = wd.window_cell(*args, **kw)
    assert wd.window_cell.launches == before + 1
    want = wd.window_cell_plain(*args, **kw)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), w.cpu()), f"field {i}"


@pytest.mark.parametrize("window", WINDOWS)
def test_window_grid_kernel_matches_plain(dev, window):
    rng = np.random.default_rng(4_242 + window)
    p, num_tags = 3, 29
    tags = torch.stack([_case(rng, p, num_tags, 300, dev)[0]
                        for _ in range(3)])
    costs = torch.stack([_case(rng, p, num_tags, 300, dev)[1]
                         for _ in range(3)])
    counts = torch.tensor([1, 4, 8], dtype=torch.int32, device=dev)
    lats = torch.tensor([0, 73], dtype=torch.int32, device=dev)
    quanta = torch.tensor([[6, 37, 120], [1 << 30] * 3, [500, 900, 700]],
                          dtype=torch.int32, device=dev)
    sched = torch.tensor([0, 1, 2, 0], dtype=torch.int32, device=dev)
    kw = dict(num_tags=num_tags, total_steps=3_000, window=window)
    args = (tags, costs, counts, lats, quanta, sched, 11, 23)
    got = wd.window_grid(*args, **kw)
    want = wd.window_grid_plain(*args, **kw)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), w.cpu()), f"field {i}"


def test_sweep_and_resume_on_card_match_scan(dev):
    rng = np.random.default_rng(5)
    fl = rng.integers(0, isa.NUM_INSTRUCTIONS, (3, 2, 400)).astype(np.int32)
    sched = simulator.SchedulerConfig(quantum_cycles=500)
    kw = dict(slot_counts=[2, 4], total_steps=900, device=dev)
    scan = simulator.sweep_fleet(fl, [10, 50], isa.SCENARIO_2, sched,
                                 path="scan", **kw)
    before = wd.window_grid.launches
    fast = simulator.sweep_fleet(fl, [10, 50], isa.SCENARIO_2, sched,
                                 path="interleaved", interleave_window=64,
                                 **kw)
    assert wd.window_grid.launches > before
    for a, b in zip(scan, fast):
        assert torch.equal(a.cpu(), b.cpu())
    cfg = simulator.ReconfigConfig(num_slots=4, miss_latency=50)
    _, st = simulator.simulate_many(fl[0], cfg, isa.SCENARIO_2, sched,
                                    total_steps=700, return_state=True,
                                    path="scan", device=dev)
    outs = [simulator.simulate_many(fl[0], cfg, isa.SCENARIO_2, sched,
                                    total_steps=600, state=st,
                                    return_state=True, path=path,
                                    device=dev)
            for path in ("scan", "interleaved")]
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a.cpu(), b.cpu())
    na, nb = (simulator.fleet_state_to_numpy(o[1]) for o in outs)
    for a, b in zip(na[2:] + tuple(na.slot_st) + tuple(na.bs_st),
                    nb[2:] + tuple(nb.slot_st) + tuple(nb.bs_st)):
        np.testing.assert_array_equal(a, b)


def test_online_serve_under_a_storm_on_card_matches_cpu(dev, monkeypatch):
    """One online serve under a seeded fault storm (`repro_torch.sched`)
    on the card equals the same serve on the CPU, report and snapshot;
    on the card the seedable segments resume through `window_cell` on the
    bitset route and the faulted ones take the reference machine."""
    from repro_torch import sched
    scans = []
    real = simulator._simulate_fleet_impl

    def spy(*a, **kw):
        scans.append(a[0].device.type)
        return real(*a, **kw)

    monkeypatch.setattr(simulator, "_simulate_fleet_impl", spy)
    pc = sched.PlacementConfig(num_slots=4, quantum_cycles=2_000,
                               trace_len=2_000, steps_per_program=2_000)
    events = [sched.TenantEvent(*e) for e in (
        (0, "arrive", "fgA", "minver"), (0, "arrive", "fgB", "cubic"),
        (0, "arrive", "m1", "qrduino"), (1, "arrive", "m2", "edn"),
        (1, "arrive", "m3", "crc32"), (2, "arrive", "m4", "tarfind"),
        (4, "depart", "m3", None), (4, "arrive", "m5", "tarfind"))]
    storm = sched.FaultPlan.storm(seed=5, num_epochs=6, num_cores=3,
                                  p_core_loss=0.15, p_seu=0.2, p_flush=0.15,
                                  p_stall=0.15)

    def serve(device):
        rep = sched.OnlineReplacer(
            sched.OnlineConfig(num_cores=3, epoch_steps=2_000,
                               probe_steps=800, placement=pc),
            faults=storm, device=device)
        return dataclasses.asdict(rep.run(events, 6)), rep.snapshot()

    want = serve("cpu")
    assert scans, "the storm sent no segment to the reference machine"
    scans.clear()
    launches, routes = wd.window_cell.launches, dict(wd.window_cell.routes)
    got = serve(dev)
    n = wd.window_cell.launches - launches
    assert n > 0
    assert {r: k - routes[r] for r, k in wd.window_cell.routes.items()} \
        == {"bitset": n, "generic": 0}
    assert scans and set(scans) == {"cuda"}
    np.testing.assert_equal(got, want)


def test_kernel_refuses_what_shared_memory_cannot_hold(dev):
    tags = torch.zeros((1, 1, 8), dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        wd.window_grid(tags, tags, one, one, one.reshape(1, 1), one - 1, 0,
                       0, num_tags=10_000, total_steps=4, window=4)


def test_bitset_route_refuses_rings_shared_memory_cannot_hold(dev):
    """32 programs at a 2,048-row window: 32 rings of 4,096 rows, 1 MB."""
    tags = torch.zeros((1, 32, 8), dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    before = dict(wd.window_grid.routes)
    with pytest.raises(ValueError, match="stream rings"):
        wd.window_grid(tags, tags, one, one,
                       torch.ones((1, 32), dtype=torch.int32, device=dev),
                       torch.arange(32, dtype=torch.int32, device=dev), 0, 0,
                       num_tags=10, total_steps=4_096, window=2_048)
    assert wd.window_grid.routes == before


# (num_tags, route): the bitset route's fig7 alphabet, the simulator's
# widest, the word's limit; the generic route just past it and far past it
ROUTE_CASES = ((10, "bitset"), (29, "bitset"), (32, "bitset"),
               (33, "generic"), (61, "generic"))


@pytest.mark.parametrize("window", (1, 33, 257))
@pytest.mark.parametrize("num_tags,route", ROUTE_CASES)
def test_window_routes_match_plain(dev, num_tags, route, window):
    """Both entry points on the route the alphabet selects, every field
    equal to the plain version, the launch counted on that route."""
    assert wd.route(num_tags, 3) == route
    rng = np.random.default_rng(num_tags * 97 + window)
    tags, costs, quanta, sched = _case(rng, 3, num_tags, 300, dev)
    seed = _seed(rng, 3, num_tags, 300, dev)
    kw = dict(num_tags=num_tags, total_steps=1_500, window=window)
    args = (tags, costs, 4, 41, quanta, sched, 9, 17, seed)
    before = dict(wd.window_cell.routes)
    got = wd.window_cell(*args, **kw)
    assert wd.window_cell.routes[route] == before[route] + 1
    want = wd.window_cell_plain(*args, **kw)
    gargs = (tags[None].expand(2, -1, -1).contiguous(),
             costs[None].expand(2, -1, -1).contiguous(),
             [1, 4, 8], [0, 73], torch.stack([quanta, quanta * 0 + 37]),
             sched, 11, 23)
    gkw = dict(num_tags=num_tags, total_steps=1_500, window=window)
    before = dict(wd.window_grid.routes)
    ggot = wd.window_grid(*gargs, **gkw)
    assert wd.window_grid.routes[route] == before[route] + 1
    gwant = wd.window_grid_plain(*gargs, **gkw)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got + ggot, want + gwant)):
        assert torch.equal(g.cpu(), w.cpu()), f"field {i}"


@pytest.mark.parametrize("window", (13, 257, 512))
def test_bitset_stats_match_the_plain_model(dev, window):
    """The kernel's trips and passes per cell equal those of
    `window_loop_bitset_plain`, which models its blocking."""
    rng = np.random.default_rng(window)
    tags, costs, quanta, sched = _case(rng, 3, 10, 300, dev)
    quanta = torch.stack([quanta, torch.full_like(quanta, 1 << 30)])
    args = (tags[None], costs[None], [2, 4], [50], quanta, sched, 11, 23)
    kw = dict(num_tags=10, total_steps=2_000, window=window)
    stats = []
    got = wd.window_grid(*args, **kw, stats=stats)
    q, b, k, l = wd._grid_cells(2, 1, 2, 1, "cpu")
    model = []
    final = wd.window_loop_bitset_plain(
        tags[None].cpu(), costs[None].cpu(), b,
        torch.tensor([2, 4], dtype=torch.int32)[k],
        torch.tensor([50], dtype=torch.int32)[l], quanta.cpu()[q],
        sched.cpu(), 11, 23, wd.cold_carry(4, 3, 10, "cpu"),
        total_steps=2_000, window=window, pos_base=0, materialise=False,
        stats=model)
    assert stats == model
    assert torch.equal(got[4].reshape(-1).cpu(), final.switches)


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------

ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _assert_close(got, want, dtype):
    tol = ATOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,h,kh,dh,window", [
    (1, 32, 8, 64, 0), (63, 8, 8, 64, 0), (64, 8, 2, 128, 0),
    (65, 8, 1, 64, 0), (1000, 32, 8, 64, 0), (300, 4, 1, 128, 50),
    (129, 8, 2, 64, 64),
    (500, 56, 8, 128, 0), (77, 40, 8, 128, 0),    # arctic G=7, llama4 G=5
    (300, 16, 1, 256, 128), (97, 4, 1, 256, 0)])  # recurrentgemma D=256
def test_flash_kernel_matches_plain(dev, dtype, t, h, kh, dh, window):
    gen = torch.Generator(device=dev).manual_seed(t * 7 + dh)
    q = _randn(gen, (2, t, h, dh), dtype, dev)
    k = _randn(gen, (2, t, kh, dh), dtype, dev)
    v = _randn(gen, (2, t, kh, dh), dtype, dev)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, window=window)
    assert fa.flash_attention.launches == before + 1
    _assert_close(got, fa.flash_attention_plain(q, k, v, window=window),
                  dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_kernel_keyless_rows_are_zero(dev, dtype, dh):
    """Tq 300 over Tk 100 with a 50-key window: rows 149 and later see no
    key and are exact zeros in both routes (as decode's kv_len 0); every
    other row equals the plain version."""
    gen = torch.Generator(device=dev).manual_seed(dh)
    q = _randn(gen, (2, 300, 4, dh), dtype, dev)
    k = _randn(gen, (2, 100, 2, dh), dtype, dev)
    v = _randn(gen, (2, 100, 2, dh), dtype, dev)
    got = fa.flash_attention(q, k, v, causal=True, window=50)
    assert torch.equal(got[:, 149:], torch.zeros_like(got[:, 149:]))
    _assert_close(got[:, :149], fa.flash_attention_plain(
        q, k, v, causal=True, window=50)[:, :149], dtype)


def test_flash_kernel_reads_strided_views(dev):
    """q/k/v as views of one fused (B, T, H + 2 KH, D) projection."""
    gen = torch.Generator(device=dev).manual_seed(11)
    fused = _randn(gen, (1, 77, 12, 64), torch.float32, dev)
    q, k, v = fused[:, :, :8], fused[:, :, 8:10], fused[:, :, 10:]
    _assert_close(fa.flash_attention(q, k, v),
                  fa.flash_attention_plain(q, k, v), torch.float32)


def test_flash_kernel_refuses_what_it_does_not_take(dev):
    q = torch.zeros((1, 8, 4, 64), device=dev)
    with pytest.raises(NotImplementedError, match="window instead"):
        fa.flash_attention(q, q, q, q_offset=8)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :32], q[..., :32], q[..., :32])
    with pytest.raises(ValueError, match="bf16 or f32"):
        fa.flash_attention(q.half(), q.half(), q.half())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,dh", [
    (4, 256, 8, 8, 64), (4, 2048, 32, 8, 64), (4, 300, 8, 1, 128),
    (4, 128, 4, 2, 128),
    (4, 2048, 56, 8, 128), (4, 333, 40, 8, 128),    # G=7 (arctic), G=5
    (4, 2048, 16, 1, 256), (4, 100, 16, 1, 256)])   # recurrentgemma G=16
def test_decode_kernel_matches_plain(dev, dtype, b, s, h, kh, dh):
    gen = torch.Generator(device=dev).manual_seed(s + h)
    q = _randn(gen, (b, h, dh), dtype, dev)
    kc = _randn(gen, (b, s, kh, dh), dtype, dev)
    vc = _randn(gen, (b, s, kh, dh), dtype, dev)
    kv_len = torch.tensor([0, 1, s, s // 3 + 5], dtype=torch.int32,
                          device=dev)
    before = da.decode_attention.launches
    got = da.decode_attention(q, kc, vc, kv_len)
    assert da.decode_attention.launches == before + 1
    assert not got[0].any(), "kv_len == 0 gives zeros"
    _assert_close(got, da.decode_attention_plain(q, kc, vc, kv_len), dtype)


def test_flash_kernel_reads_strided_views_bf16(dev):
    """The bf16 route's TMA descriptors over views of one fused (B, T, H +
    2 KH, D) projection, at head dims 64 and 128."""
    gen = torch.Generator(device=dev).manual_seed(12)
    for dh, t in ((64, 77), (128, 300)):
        fused = _randn(gen, (2, t, 12, dh), torch.bfloat16, dev)
        q, k, v = fused[:, :, :8], fused[:, :, 8:10], fused[:, :, 10:]
        _assert_close(fa.flash_attention(q, k, v, window=50 if dh == 64
                                         else 0),
                      fa.flash_attention_plain(q, k, v, window=50 if dh == 64
                                               else 0), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,window", [(4096, 2048), (1000, 0)])
def test_flash_kernel_long_prompts_at_head_dim_256(dev, dtype, t, window):
    """recurrentgemma's shape: a prompt of two 2,048-token windows (key
    tiles older than the window skipped), 16 query heads over 1."""
    gen = torch.Generator(device=dev).manual_seed(t + window)
    q = _randn(gen, (1, t, 16, 256), dtype, dev)
    k = _randn(gen, (1, t, 1, 256), dtype, dev)
    v = _randn(gen, (1, t, 1, 256), dtype, dev)
    _assert_close(fa.flash_attention(q, k, v, window=window),
                  fa.flash_attention_plain(q, k, v, window=window), dtype)


# every query-heads-per-kv-head ratio of the zoo, at its head dim
ZOO_GROUPS = [(1, 64), (3, 128), (4, 64), (5, 128), (7, 128), (8, 128),
              (16, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,dh", ZOO_GROUPS)
def test_attention_kernels_take_every_group_of_the_zoo(dev, dtype, g, dh):
    gen = torch.Generator(device=dev).manual_seed(g * 1000 + dh)
    kh = 2
    q = _randn(gen, (2, 333, g * kh, dh), dtype, dev)
    k = _randn(gen, (2, 333, kh, dh), dtype, dev)
    v = _randn(gen, (2, 333, kh, dh), dtype, dev)
    _assert_close(fa.flash_attention(q, k, v),
                  fa.flash_attention_plain(q, k, v), dtype)
    kv_len = torch.tensor([333, 129], dtype=torch.int32, device=dev)
    _assert_close(da.decode_attention(q[:, 0], k, v, kv_len),
                  da.decode_attention_plain(q[:, 0], k, v, kv_len), dtype)


def _split_edges(s, chunk, b):
    """kv_len at and beside the tile and split edges, cycled to b rows."""
    edges = [0, 1, 63, 64, 65, 127, 128, 129, chunk - 1, chunk, chunk + 1,
             2 * chunk - 1, 2 * chunk, 2 * chunk + 1, s - 1, s]
    edges = [e for e in edges if 0 <= e <= s]
    return [edges[i % len(edges)] for i in range(b)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,kh,g,s,dh", [
    (1, 1, 16, 2048, 256), (2, 1, 4, 700, 64), (8, 1, 16, 2048, 256),
    (4, 4, 4, 2048, 64), (8, 8, 4, 2048, 64), (16, 4, 7, 1000, 128),
    (8, 8, 5, 4096, 128)])
def test_decode_kernel_at_split_edges(dev, dtype, b, kh, g, s, dh):
    """kv_len at 64 k, 64 k +- 1 and the split edges (every split but the
    first empty, or but the first two), B x KH from 1 to 64: the kernel
    against the plain version and the plain form of its split-and-merge
    arithmetic; kv_len 0 exact zeros."""
    splits, chunk = da.split_plan(b, kh, s)
    gen = torch.Generator(device=dev).manual_seed(b * kh + s)
    q = _randn(gen, (b, kh * g, dh), dtype, dev)
    kc = _randn(gen, (b, s, kh, dh), dtype, dev)
    vc = _randn(gen, (b, s, kh, dh), dtype, dev)
    lens = _split_edges(s, chunk, b)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = da.decode_attention(q, kc, vc, kv_len)
    _assert_close(got, da.decode_attention_plain(q, kc, vc, kv_len), dtype)
    _assert_close(got, da.decode_attention_split_plain(q, kc, vc, kv_len),
                  dtype)
    for i, n in enumerate(lens):
        if n == 0:
            assert not got[i].any(), "kv_len == 0 gives zeros"


def test_attention_wrappers_never_synchronise(dev):
    """Neither wrapper reads a device value on the host: under CUDA's
    sync debug mode "error" a synchronising call would raise."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q = _randn(gen, (8, 16, 256), torch.bfloat16, dev)
    kc = _randn(gen, (8, 2048, 1, 256), torch.bfloat16, dev)
    kv_len = torch.full((8,), 999, dtype=torch.int32, device=dev)
    x = _randn(gen, (1, 300, 8, 64), torch.bfloat16, dev)
    da.decode_attention(q, kc, kc, kv_len)        # builds, loads
    fa.flash_attention(x, x[:, :, :2], x[:, :, :2])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        da.decode_attention(q, kc, kc, kv_len)
        fa.flash_attention(x, x[:, :, :2], x[:, :, :2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_attention_kernels_report_their_shared_memory(dev):
    assert fa.smem_bytes(256, torch.bfloat16) == \
        1024 + 2 * 128 * 256 + 2 * 2 * 2 * 64 * 256 + 8 * 7
    assert fa.smem_bytes(256, torch.float32) == 4 * (64 + 2 * 64) * 260
    assert da.smem_bytes(16, 256, torch.bfloat16) == \
        2 * (16 + 4 * 64) * 264 + 2 * 4 * 4 * 16
    assert da.smem_bytes(16, 256, torch.float32) <= 232_448


def test_model_on_card_matches_plain_and_launches_both_kernels(dev):
    """A two-layer granite at smoke width but head dim 64: prefill and
    three decode steps through the kernels equal the plain path."""
    cb.load_all()
    cfg = dataclasses.replace(cb.get_config("granite-3-2b").smoke(),
                              head_dim=64)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    outs = {}
    for mode in ("auto", "plain"):
        f0, d0 = fa.flash_attention.launches, da.decode_attention.launches
        logits, cache, _ = transformer.prefill(
            cfg, params, {"tokens": tokens[:, :37]}, use_kernel=mode)
        cache = [[{n: torch.nn.functional.pad(c[n], (0, 0, 0, 0, 0, 3))
                   for n in c} for c in seg] for seg in cache]
        steps = [logits]
        for i in range(37, 40):
            logits, cache, _ = transformer.decode_step(
                cfg, params, {"tokens": tokens[:, i:i + 1],
                              "positions": np.full((2,), i, np.int32)},
                cache, use_kernel=mode)
            steps.append(logits)
        launched = (fa.flash_attention.launches - f0,
                    da.decode_attention.launches - d0)
        assert launched == ((2, 6) if mode == "auto" else (0, 0))
        outs[mode] = torch.cat(steps, 1)
    _assert_close(outs["auto"], outs["plain"], torch.float32)


# ---------------------------------------------------------------------------
# grouped expert FFN
# ---------------------------------------------------------------------------

GMM_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _gmm_inputs(gen, e, c, d, f, dtype, dev):
    return (_randn(gen, (e, c, d), dtype, dev) * 0.5,
            _randn(gen, (e, d, f), dtype, dev) * d ** -0.5,
            _randn(gen, (e, d, f), dtype, dev) * d ** -0.5,
            _randn(gen, (e, f, d), dtype, dev) * f ** -0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f,gated", [
    (2, 128, 128, 256, True), (4, 128, 256, 512, True),
    (2, 128, 128, 128, False), (4, 64, 64, 128, True),    # test_kernels.py
    (3, 24, 96, 80, True), (3, 24, 96, 80, False),        # ragged
    (5, 5, 40, 36, True), (2, 33, 64, 72, True)])          # odd rows
def test_moe_gmm_kernels_match_plain(dev, dtype, e, c, d, f, gated):
    gen = torch.Generator(device=dev).manual_seed(e * 131 + c + d + f)
    x, wg, wi, wo = _gmm_inputs(gen, e, c, d, f, dtype, dev)
    tol = GMM_ATOL[dtype]
    before = (gmm.moe_gmm.launches, gmm.moe_gmm_skip.launches)
    got = gmm.moe_gmm(x, wg, wi, wo, gated=gated)
    torch.testing.assert_close(
        got.float(), gmm.moe_gmm_plain(x, wg, wi, wo, gated=gated).float(),
        atol=tol, rtol=tol)
    counts = torch.tensor([(i % 3) * 2 for i in range(e)], dtype=torch.int32,
                          device=dev)
    got = gmm.moe_gmm_skip(x, wg, wi, wo, counts, gated=gated)
    assert (gmm.moe_gmm.launches, gmm.moe_gmm_skip.launches) == \
        (before[0] + 1, before[1] + 1)
    want = gmm.moe_gmm_skip_plain(x, wg, wi, wo, counts, gated=gated)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    dead = counts == 0
    assert not got[dead].any(), "empty experts are exact zeros"


def test_moe_gmm_kernel_refuses_what_it_does_not_take(dev):
    x = torch.zeros((2, 8, 16), device=dev)
    w, wo = torch.zeros((2, 16, 32), device=dev), \
        torch.zeros((2, 32, 16), device=dev)
    with pytest.raises(ValueError, match="bf16 or f32"):
        gmm.moe_gmm(x.half(), w.half(), w.half(), wo.half())
    with pytest.raises(ValueError, match="shape"):
        gmm.moe_gmm(x, w, w, wo[:, :16])
    with pytest.raises(ValueError, match="contiguous"):
        gmm.moe_gmm(x, w.transpose(1, 2).contiguous().transpose(1, 2), w, wo)
    with pytest.raises(ValueError, match="counts"):
        gmm.moe_gmm_skip(x, w, w, wo, torch.ones(2, device=dev))


def _gmm_pair(x, wg, wi, wo, counts, gated):
    """Both entry points and their plain versions on one input."""
    return ((gmm.moe_gmm(x, wg, wi, wo, gated=gated),
             gmm.moe_gmm_plain(x, wg, wi, wo, gated=gated)),
            (gmm.moe_gmm_skip(x, wg, wi, wo, counts, gated=gated),
             gmm.moe_gmm_skip_plain(x, wg, wi, wo, counts, gated=gated)))


@pytest.mark.parametrize("c", [1, 8, 16, 24, 32, 40, 128])
@pytest.mark.parametrize("d,f,gated", [(136, 200, True), (96, 80, False),
                                       (256, 128, True)])
def test_moe_gmm_tensor_core_route_at_every_capacity(dev, c, d, f, gated):
    """bf16 at the model path's capacities and beyond (C > 32 runs in
    passes), D and F multiples of 8 that no tile divides, both epilogues:
    every call takes the tensor-core route and equals the plain version;
    the skip's dead experts are exact zeros."""
    gen = torch.Generator(device=dev).manual_seed(c * 7 + d + f)
    e = 5
    x, wg, wi, wo = _gmm_inputs(gen, e, c, d, f, torch.bfloat16, dev)
    counts = torch.tensor([0, c, 1, 0, max(1, c // 2)], dtype=torch.int32,
                          device=dev)
    before = (dict(gmm.moe_gmm.routes), dict(gmm.moe_gmm_skip.routes))
    tol = GMM_ATOL[torch.bfloat16]
    for got, want in _gmm_pair(x, wg, wi, wo, counts, gated):
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    assert gmm.moe_gmm.routes["mma"] == before[0]["mma"] + 1
    assert gmm.moe_gmm_skip.routes["mma"] == before[1]["mma"] + 1
    assert (gmm.moe_gmm.routes["fma"], gmm.moe_gmm_skip.routes["fma"]) == \
        (before[0]["fma"], before[1]["fma"])
    got = gmm.moe_gmm_skip(x, wg, wi, wo, counts, gated=gated)
    assert not got[counts == 0].any(), "empty experts are exact zeros"


def test_moe_gmm_route_follows_dtype_shape_and_alignment(dev):
    """f32, and bf16 rows that are not 16-byte aligned (F 36), take the
    CUDA-core route; bf16 with D and F multiples of 8 the tensor cores."""
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = ((torch.float32, 64, 128, "fma"), (torch.bfloat16, 40, 36, "fma"),
             (torch.bfloat16, 40, 48, "mma"))
    for dtype, d, f, route in cases:
        x, wg, wi, wo = _gmm_inputs(gen, 3, 8, d, f, dtype, dev)
        before = dict(gmm.moe_gmm.routes)
        gmm.moe_gmm(x, wg, wi, wo)
        assert gmm.moe_gmm.routes[route] == before[route] + 1, (dtype, f)


def test_moe_gmm_path_shapes_take_the_tensor_core_route(dev):
    """arctic-480b's expert widths (D 7168, F 4864, bf16) on 3 experts, at
    a prefill's capacity 24 and a decode step's 8 (one expert dead): both
    entry points take the tensor-core route and equal the plain version."""
    gen = torch.Generator(device=dev).manual_seed(3)
    tol = GMM_ATOL[torch.bfloat16]
    for c in (24, 8):
        x, wg, wi, wo = _gmm_inputs(gen, 3, c, 7168, 4864, torch.bfloat16,
                                    dev)
        counts = torch.tensor([c, 0, 3], dtype=torch.int32, device=dev)
        before = (gmm.moe_gmm.routes["mma"], gmm.moe_gmm_skip.routes["mma"])
        for got, want in _gmm_pair(x, wg, wi, wo, counts, True):
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)
        assert (gmm.moe_gmm.routes["mma"], gmm.moe_gmm_skip.routes["mma"]) \
            == (before[0] + 1, before[1] + 1)
        del x, wg, wi, wo


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_skip_never_reads_dead_experts(dev, dtype):
    """Dead experts' weights (and rows) filled with NaN: their outputs are
    exact zeros and no NaN reaches any output, so they were never read."""
    gen = torch.Generator(device=dev).manual_seed(4)
    x, wg, wi, wo = _gmm_inputs(gen, 6, 8, 128, 256, dtype, dev)
    counts = torch.tensor([3, 0, 8, 0, 0, 1], dtype=torch.int32, device=dev)
    dead = counts == 0
    for t in (x, wg, wi, wo):
        t[dead] = float("nan")
    got = gmm.moe_gmm_skip(x, wg, wi, wo, counts)
    assert not got.isnan().any()
    assert not got[dead].any()
    want = gmm.moe_gmm_skip_plain(x, wg, wi, wo, counts)
    tol = GMM_ATOL[dtype]
    torch.testing.assert_close(got[~dead].float(), want[~dead].float(),
                               atol=tol, rtol=tol)


def test_moe_gmm_wrappers_never_synchronise(dev):
    """Neither entry point reads a device value on the host (the counts
    stay on the card): under CUDA's sync debug mode "error" a
    synchronising call would raise."""
    gen = torch.Generator(device=dev).manual_seed(6)
    x, wg, wi, wo = _gmm_inputs(gen, 8, 8, 256, 512, torch.bfloat16, dev)
    counts = torch.tensor([0, 1, 8, 0, 2, 0, 0, 5], dtype=torch.int32,
                          device=dev)
    gmm.moe_gmm(x, wg, wi, wo)                    # builds, loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gmm.moe_gmm(x, wg, wi, wo)
        gmm.moe_gmm_skip(x, wg, wi, wo, counts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_moe_model_on_card_matches_plain_and_launches_both_kernels(dev):
    """A two-layer arctic at smoke width but head dim 64: prefill and three
    decode steps through the kernels equal the plain path; prefill runs
    moe_gmm and each decode step moe_gmm_skip, once a layer."""
    cb.load_all()
    cfg = dataclasses.replace(cb.get_config("arctic-480b").smoke(),
                              head_dim=64)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    outs = {}
    for mode in ("auto", "plain"):
        g0, s0 = gmm.moe_gmm.launches, gmm.moe_gmm_skip.launches
        logits, cache, aux = transformer.prefill(
            cfg, params, {"tokens": tokens[:, :37]}, use_kernel=mode)
        loads = [aux[0][0]["expert_load"]]
        cache = [[{n: torch.nn.functional.pad(c[n], (0, 0, 0, 0, 0, 3))
                   for n in c} for c in seg] for seg in cache]
        steps = [logits]
        for i in range(37, 40):
            logits, cache, aux = transformer.decode_step(
                cfg, params, {"tokens": tokens[:, i:i + 1],
                              "positions": np.full((2,), i, np.int32)},
                cache, use_kernel=mode)
            steps.append(logits)
            loads.append(aux[0][0]["expert_load"])
        launched = (gmm.moe_gmm.launches - g0, gmm.moe_gmm_skip.launches - s0)
        assert launched == ((2, 6) if mode == "auto" else (0, 0))
        outs[mode] = (torch.cat(steps, 1), torch.cat(loads))
    _assert_close(outs["auto"][0], outs["plain"][0], torch.float32)
    assert torch.equal(outs["auto"][1], outs["plain"][1])


# ---------------------------------------------------------------------------
# recurrent scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,w,start", [
    (2, 128, 128, False), (1, 256, 256, False), (2, 64, 512, False),
    (3, 77, 200, True), (2, 1, 4096, True), (1, 1024, 4096, True)])
def test_rglru_kernel_matches_plain(dev, dtype, b, t, w, start):
    gen = torch.Generator(device=dev).manual_seed(b * t + w)
    u = _randn(gen, (b, t, w), dtype, dev)
    params = [_randn(gen, (w,), torch.float32, dev) * 0.1 for _ in range(4)]
    params.append(torch.linspace(2.0, 6.0, w, device=dev))
    h0 = _randn(gen, (b, w), torch.float32, dev) if start else None
    before = rgs.rglru_scan.launches
    got = rgs.rglru_scan(u, *params, h0)
    assert rgs.rglru_scan.launches == before + 1
    want = rgs.rglru_scan_plain(u, *params, h0)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, atol=2e-5, rtol=2e-5)


def test_rglru_kernel_reads_strided_u(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    u = _randn(gen, (2, 40, 96), torch.float32, dev)[:, ::2, :64]
    params = [_randn(gen, (64,), torch.float32, dev) * 0.1
              for _ in range(5)]
    for g, w_ in zip(rgs.rglru_scan(u, *params),
                     rgs.rglru_scan_plain(u, *params)):
        torch.testing.assert_close(g, w_, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,n,start", [
    (1, 128, 2, 32, False), (2, 128, 1, 64, False), (1, 64, 3, 16, False),
    (2, 37, 4, 16, True), (8, 1, 64, 64, True), (1, 300, 8, 64, True)])
def test_rwkv6_kernel_matches_plain(dev, dtype, b, t, h, n, start):
    gen = torch.Generator(device=dev).manual_seed(b + t + h + n)
    r, k, v = (_randn(gen, (b, t, h, n), dtype, dev) for _ in range(3))
    logw = -torch.exp(_randn(gen, (b, t, h, n), torch.float32, dev) * 0.5)
    u = _randn(gen, (h, n), torch.float32, dev) * 0.1
    s0 = _randn(gen, (b, h, n, n), torch.float32, dev) if start else None
    before = rws.rwkv6_scan.launches
    got = rws.rwkv6_scan(r, k, v, logw, u, s0)
    assert rws.rwkv6_scan.launches == before + 1
    want = rws.rwkv6_scan_plain(r, k, v, logw, u, s0)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, atol=5e-4, rtol=5e-4)


def test_rglru_chunked_route_reads_strided_u(dev):
    """The chunked route reads u through its strides too (a view whose
    time stride is twice its width, past two chunks)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    u = _randn(gen, (2, 400, 96), torch.bfloat16, dev)[:, ::2, :64]
    params = [_randn(gen, (64,), torch.float32, dev) * 0.1
              for _ in range(5)]
    h0 = _randn(gen, (2, 64), torch.float32, dev)
    got = _on_route(rgs.rglru_scan, "chunked", u, *params, h0)
    for g, w_ in zip(got, rgs.rglru_scan_plain(u, *params, h0)):
        torch.testing.assert_close(g, w_, atol=2e-5, rtol=2e-5)


def _on_route(fn, route, *args):
    """fn(*args) through the wrapper, which must count one launch, on
    `route`."""
    before, launches = dict(fn.routes), fn.launches
    out = fn(*args)
    assert fn.launches == launches + 1
    assert {k: fn.routes[k] - before[k] for k in fn.routes} == {
        k: int(k == route) for k in fn.routes}
    return out


def _unaligned(x):
    """A contiguous copy of x whose data starts one element past a 16-byte
    boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:].copy_(x.flatten())
    return flat[1:].view(x.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("b,t,h,n,start,strong", [
    (1, 1, 2, 16, True, False), (2, 7, 4, 64, True, False),
    (2, 37, 4, 16, False, False), (1, 100, 3, 32, True, False),
    (1, 777, 4, 64, True, False), (2, 100, 2, 64, True, True)])
def test_rwkv6_kernel_routes_match_plain(dev, dtype, aligned, b, t, h, n,
                                         start, strong):
    """Both routes at ragged T (below a sub-chunk too), from zero and from
    a state, and at strong decay (logw down to -20 a step), each picked by
    the wrapper: the chunked one from T 32 with 16-byte aligned operands,
    the step one below it and for an unaligned view at any T."""
    gen = torch.Generator(device=dev).manual_seed(b + t + h + n)
    r, k, v = (_randn(gen, (b, t, h, n), dtype, dev) for _ in range(3))
    if not aligned:
        r, k, v = _unaligned(r), _unaligned(k), _unaligned(v)
    if strong:
        logw = -20.0 * torch.rand((b, t, h, n), generator=gen, device=dev)
    else:
        logw = -torch.exp(_randn(gen, (b, t, h, n), torch.float32, dev) *
                          0.5)
    u = _randn(gen, (h, n), torch.float32, dev) * 0.1
    s0 = _randn(gen, (b, h, n, n), torch.float32, dev) if start else None
    route = "chunked" if aligned and t >= 2 * rws.SUB_CHUNK else "step"
    got = _on_route(rws.rwkv6_scan, route, r, k, v, logw, u, s0)
    want = rws.rwkv6_scan_plain(r, k, v, logw, u, s0)
    for g, w_ in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w_, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,w,start,strong", [
    (2, 65, 200, True, False), (1, 100, 4096, False, False),
    (1, 777, 512, True, False), (2, 2040, 256, True, False),
    (1, 300, 512, True, True), (2, 64, 200, True, False),
    (8, 1, 4096, True, False), (1, 37, 512, False, False),
    (2, 50, 512, True, True), (1, 7, 4096, True, False)])
def test_rglru_kernel_routes_match_plain(dev, dtype, b, t, w, start,
                                         strong):
    """Both routes, each picked by the wrapper (chunked past one 64-step
    chunk, step up to it), at ragged T, from zero and from h0, and at
    strong decay (lam 6, r near 1)."""
    gen = torch.Generator(device=dev).manual_seed(b * t + w)
    u = _randn(gen, (b, t, w), dtype, dev)
    params = [_randn(gen, (w,), torch.float32, dev) * 0.1 for _ in range(4)]
    params.append(torch.linspace(2.0, 6.0, w, device=dev))
    if strong:
        params[1] = params[1] + 8.0
        params[4] = torch.full((w,), 6.0, device=dev)
    h0 = _randn(gen, (b, w), torch.float32, dev) if start else None
    route = "chunked" if t > rgs.CHUNK else "step"
    got = _on_route(rgs.rglru_scan, route, u, *params, h0)
    want = rgs.rglru_scan_plain(u, *params, h0)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, atol=2e-5, rtol=2e-5)


def test_scan_wrappers_pick_and_count_routes(dev):
    """A prefill takes the chunked route, a decode step (T 1) the step
    route, and so does an unaligned WKV prefill; the wrappers count each
    launch under the route it took."""
    gen = torch.Generator(device=dev).manual_seed(7)
    f = lambda *shape: _randn(gen, shape, torch.bfloat16, dev)
    x = lambda *shape: _randn(gen, shape, torch.float32, dev)
    params = [x(256) * 0.1 for _ in range(4)] + [
        torch.linspace(2.0, 6.0, 256, device=dev)]
    for t, route in ((100, "chunked"), (1, "step")):
        _on_route(rgs.rglru_scan, route, f(1, t, 256), *params, x(1, 256))
        _on_route(rws.rwkv6_scan, route, f(1, t, 2, 64), f(1, t, 2, 64),
                  f(1, t, 2, 64), -torch.exp(x(1, t, 2, 64) * 0.5),
                  x(2, 64) * 0.1, x(1, 2, 64, 64))
    _on_route(rws.rwkv6_scan, "step", _unaligned(f(1, 100, 2, 64)),
              f(1, 100, 2, 64), f(1, 100, 2, 64),
              -torch.exp(x(1, 100, 2, 64) * 0.5), x(2, 64) * 0.1)


def test_scan_kernels_refuse_what_they_do_not_take(dev):
    w = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="bf16 or f32"):
        rgs.rglru_scan(torch.zeros((1, 3, 8), device=dev).half(), w, w, w,
                       w, w)
    with pytest.raises(ValueError, match="h0"):
        rgs.rglru_scan(torch.zeros((1, 3, 8), device=dev), w, w, w, w, w,
                       torch.zeros((2, 8), device=dev))
    x = torch.zeros((1, 3, 2, 48), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        rws.rwkv6_scan(x, x, x, x, torch.zeros((2, 48), device=dev))
    x = torch.zeros((1, 3, 2, 16), device=dev)
    with pytest.raises(ValueError, match="logw"):
        rws.rwkv6_scan(x.bfloat16(), x.bfloat16(), x.bfloat16(),
                       x.bfloat16(), torch.zeros((2, 16), device=dev))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_recurrent_model_on_card_matches_plain_and_launches_kernels(dev,
                                                                   arch):
    """The smoke recurrent archs (recurrentgemma at head dim 64, so the
    attention kernels take it): a 64-token prompt (two of its 32-token
    windows) and 8 decode steps around the ring through the kernels equal
    the plain path; every recurrent block launches its scan at prefill
    and at each step."""
    cb.load_all()
    cfg = cb.get_config(arch).smoke()
    if cfg.window:
        cfg = dataclasses.replace(cfg, head_dim=64)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 72)).astype(np.int32)
    kernel = rgs.rglru_scan if cfg.window else rws.rwkv6_scan
    blocks = sum(t in ("rec", "rwkv") for types, n in
                 transformer.segments(cfg) for t in types for _ in range(n))
    outs = {}
    for mode in ("auto", "plain"):
        before = kernel.launches
        logits, cache, _ = transformer.prefill(
            cfg, params, {"tokens": tokens[:, :64]}, use_kernel=mode)
        steps = [logits]
        for i in range(64, 72):
            logits, cache, _ = transformer.decode_step(
                cfg, params, {"tokens": tokens[:, i:i + 1],
                              "positions": np.full((2,), i, np.int32)},
                cache, use_kernel=mode)
            steps.append(logits)
        assert kernel.launches - before == \
            (9 * blocks if mode == "auto" else 0)
        outs[mode] = torch.cat(steps, 1)
    torch.testing.assert_close(outs["auto"], outs["plain"], atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the simulator's perf benchmarks and the model-zoo study on the card
# ---------------------------------------------------------------------------

def test_window_kernel_bench_runs_the_kernel_with_parity(dev):
    from repro_torch.bench import window_kernel

    rows, r = window_kernel.run(dev)      # asserts parity before timing
    assert r["kernel_mode"] == "cuda"
    assert r["routes"]["window_grid"]["bitset"] > 0
    assert r["routes"]["window_cell"]["bitset"] > 0
    assert r["routes"]["window_grid"]["generic"] == 0
    assert r["kernel_s"] > 0 and r["resume_kernel_s"] > 0


def test_perf_sweep_sections_on_card_at_a_small_size(dev, monkeypatch):
    from repro_torch.bench import perf_sweep

    for k, v in dict(P4_FLEETS=2, P4_TRACE_LEN=300, P4_TOTAL_STEPS=700,
                     P4_QUANTUM=150, RS_TRACE_LEN=400,
                     RS_TOTAL_STEPS=900).items():
        monkeypatch.setattr(perf_sweep, k, v)
    # both arms of the P=4 section replay CUDA graphs of the step
    assert perf_sweep.bench_p4_preempted(dev)["parity"]
    r = perf_sweep.bench_resumed_segment(dev)
    assert r["parity"] and r["speedup"] > 0


def test_model_serve_study_p2_on_card_matches_cpu(dev):
    from repro_torch.bench import model_serve_study as mss
    from repro_torch.sched import ContentionModel

    # the same mixes: the port's counter, cached in this process
    on_card = mss.study(2, mss.FLEET, ContentionModel(mss.CFG, device=dev))
    on_cpu = mss.study(2, mss.FLEET, ContentionModel(mss.CFG, device="cpu"))
    assert on_card == on_cpu
    assert on_card["placed_worst"] <= on_card["random_worst_mean"]
