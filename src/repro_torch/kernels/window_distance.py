"""The interleaved engine's window pass: Hopper kernel and plain version.

PyTorch port of the JAX package's Pallas kernel
`repro.kernels.window_distance` (`window_grid`, `window_cell`, loop body
`_window_loop`).  Each cell of a {quantum x fleet x slots x latency} grid
runs the window loop until `total_steps` accesses committed; one trip
commits one scheduler window of the scheduled program: gather its next W
tags/costs, take each access's stack distance in the merged stream from a
per-tag cummax seeded with the carried `last_pos`, classify cold/miss,
cumsum the cycle costs from the open quantum, cut at the first quantum
expiry and fold the committed prefix back into the carry (module docstring
of `repro_torch.core.stackdist_interleaved`).

Two implementations, bit-for-bit equal (all int32):

* the CUDA kernel `csrc/window_distance.cu` for `sm_90a`: one CTA per
  cell for the whole run, on one of two routes its C entry point picks
  from the shapes (`route` is the rule, mirrored here): "bitset" for
  alphabets of at most 32 tags and fleets of at most 32 programs (tag
  sets as 32-bit words, passes of 256 rows in warp sub-chunks, the
  streams staged through a shared-memory ring), "generic" otherwise (the
  per-tag vectors and row bitmasks in shared memory).  It is built with
  `nvcc` from the source in this package at first use into
  `kernels/build/` and bound with `ctypes`;
* the plain version (`window_loop_plain`, exposed with the kernel's
  signatures as `window_grid_plain` / `window_cell_plain`): the batched
  PyTorch body, every cell a row of one batch stepped in a Python loop
  until all cells are done (a finished cell freezes).  The CPU tests run
  it, and `chip_smoke.py` holds the kernel against it on the card.

`window_loop_bitset_plain` models the bitset route's blocking step for
step in plain PyTorch; only the tests run it.

`window_grid` and `window_cell` dispatch on the device of their tensors:
CUDA tensors launch the kernel (or raise), CPU tensors run the plain
version.  Each counts its kernel launches in a plain integer attribute
(`window_grid.launches`, `window_cell.launches`) and its launches per
route in a dict (`window_grid.routes`, `window_cell.routes`).  `cost` is
the kernel's count for a cost counter (`analysis.cost`), whichever
version runs, and its bound.
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from repro_torch.analysis import cost as _cost
from repro_torch.kernels import common
from repro_torch.kernels.common import resolve

__all__ = ["window_grid", "window_cell", "window_grid_plain",
           "window_cell_plain", "window_loop_plain",
           "window_loop_bitset_plain", "route", "ROUTES", "resolve",
           "build", "cost", "Carry"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "window_distance.cu")
# the shared memory a Hopper block may use, static and dynamic together
_SMEM_LIMIT = 232_448
ROUTES = ("bitset", "generic")


# ---------------------------------------------------------------------------
# plain version: the batched PyTorch window loop
# ---------------------------------------------------------------------------


class Carry(NamedTuple):
    """Batched cell carry: `CellCarry` with a leading cell axis C."""

    last_pos: torch.Tensor   # (C, T)
    last_miss: torch.Tensor  # (C, T)
    cursors: torch.Tensor    # (C, P)
    sched_idx: torch.Tensor  # (C,)
    steps_done: torch.Tensor  # (C,)
    q_cycles: torch.Tensor   # (C,)
    cycles: torch.Tensor     # (C, P)
    instrs: torch.Tensor     # (C, P)
    misses: torch.Tensor     # (C, P)
    bs_misses: torch.Tensor  # (C, P)
    switches: torch.Tensor   # (C,)


def cold_carry(cells: int, num_progs: int, num_tags: int,
               device) -> Carry:
    """Carry of `cells` cells that start cold (step 0, empty caches)."""
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    neg = torch.full((cells, num_tags), -1, dtype=torch.int32, device=device)
    return Carry(last_pos=neg, last_miss=neg.clone(),
                 cursors=z(cells, num_progs), sched_idx=z(cells),
                 steps_done=z(cells), q_cycles=z(cells),
                 cycles=z(cells, num_progs), instrs=z(cells, num_progs),
                 misses=z(cells, num_progs), bs_misses=z(cells, num_progs),
                 switches=z(cells))


def window_loop_plain(ptags: torch.Tensor, pcosts: torch.Tensor,
                      cell_fleet: torch.Tensor, num_active: torch.Tensor,
                      miss_latency: torch.Tensor, quanta: torch.Tensor,
                      schedule: torch.Tensor, handler, bs_extra,
                      init: Carry, *, total_steps: int, window: int,
                      pos_base: int, materialise: bool) -> Carry:
    """Run C cells of the window loop to `total_steps` committed accesses.

    `ptags`/`pcosts` are (B, P, N) int32 pre-gathered tag/cost streams and
    `cell_fleet` (C,) picks each cell's fleet; `num_active`, `miss_latency`
    (C,) and `quanta` (C, P) are the cells' coordinates, `schedule` the
    weighted round-robin turn order shared by every cell.  `init` seeds
    the carry (its `steps_done` must be 0).  This is the reference's
    `vmap^4` over a `lax.while_loop` written out: one Python trip per
    window over the whole batch, with a cell whose steps are done frozen
    exactly as a vmapped while-loop selects the old carry for it.
    """
    dev = ptags.device
    _, num_progs, trace_len = ptags.shape
    num_tags = init.last_pos.shape[1]
    sched_len = schedule.shape[0]
    flat_tags = ptags.reshape(-1)
    flat_costs = pcosts.reshape(-1)
    row_base = cell_fleet.long() * num_progs
    warange = torch.arange(window, dtype=torch.int32, device=dev)
    tag_ids = torch.arange(num_tags, dtype=torch.int32, device=dev)
    parange = torch.arange(num_progs, device=dev)
    handler = torch.as_tensor(handler, dtype=torch.int32, device=dev)
    bs_extra = torch.as_tensor(bs_extra, dtype=torch.int32, device=dev)
    c = init
    while True:
        active = c.steps_done < total_steps
        if not bool(active.any()):
            return c
        p = schedule[c.sched_idx.long()].long()
        cur = c.cursors.gather(1, p[:, None])[:, 0]
        idx = torch.remainder(cur[:, None] + warange, trace_len)
        flat = (row_base + p)[:, None] * trace_len + idx.long()
        w_tags = flat_tags[flat]
        w_hw = flat_costs[flat]
        slotted = w_tags >= 0

        # merged-stream stack distances for the whole window in one pass
        pos = pos_base + c.steps_done[:, None] + warange
        match = w_tags[:, :, None] == tag_ids
        occ = torch.where(match, pos[:, :, None], -1)
        cm = torch.cummax(occ, dim=1).values
        lp = c.last_pos[:, None, :]
        prev = torch.cat([lp, torch.maximum(cm[:, :-1], lp)], dim=1)
        safe = w_tags.clamp(min=0).long()
        prev_self = prev.gather(2, safe[:, :, None])[:, :, 0]
        cold = slotted & (prev_self < 0)
        dist = (prev > prev_self[:, :, None]).sum(2, dtype=torch.int32)
        miss = slotted & (cold | (dist >= num_active[:, None]))

        cost = (w_hw + miss.to(torch.int32) * miss_latency[:, None]
                + cold.to(torch.int32) * bs_extra)
        cum = c.q_cycles[:, None] + torch.cumsum(cost, 1, dtype=torch.int32)
        quantum = quanta.gather(1, p[:, None])[:, 0]
        expire = cum >= quantum[:, None]
        any_exp = expire.any(1)
        first = torch.where(expire, warange, window).min(1).values
        n_exp = torch.where(any_exp, first + 1, window)
        remaining = total_steps - c.steps_done
        n = torch.minimum(n_exp, remaining)
        do_switch = any_exp & (n_exp <= remaining)

        last_row = (n - 1).clamp(min=0).long()   # frozen cells: n <= 0
        committed = cm.gather(
            1, last_row[:, None, None].expand(-1, 1, num_tags))[:, 0]
        if materialise:
            cm_miss = torch.cummax(
                torch.where(match & miss[:, :, None], pos[:, :, None], -1),
                dim=1).values
            last_miss = torch.maximum(c.last_miss, cm_miss.gather(
                1, last_row[:, None, None].expand(-1, 1, num_tags))[:, 0])
        else:
            last_miss = c.last_miss
        end_cum = cum.gather(1, last_row[:, None])[:, 0]
        run_cycles = (end_cum - c.q_cycles
                      + do_switch.to(torch.int32) * handler)
        in_run = warange < n[:, None]
        onehot = (parange == p[:, None]).to(torch.int32)
        new = Carry(
            last_pos=torch.maximum(c.last_pos, committed),
            last_miss=last_miss,
            cursors=c.cursors + onehot * n[:, None],
            sched_idx=torch.where(do_switch, (c.sched_idx + 1) % sched_len,
                                  c.sched_idx),
            steps_done=c.steps_done + n,
            q_cycles=torch.where(do_switch, 0, end_cum),
            cycles=c.cycles + onehot * run_cycles[:, None],
            instrs=c.instrs + onehot * n[:, None],
            misses=c.misses + onehot * (miss & in_run).sum(
                1, dtype=torch.int32)[:, None],
            bs_misses=c.bs_misses + onehot * (cold & in_run).sum(
                1, dtype=torch.int32)[:, None],
            switches=c.switches + do_switch.to(torch.int32),
        )
        c = Carry(*(torch.where(
            active.view((-1,) + (1,) * (x.dim() - 1)), x, old).to(
                torch.int32) for x, old in zip(new, c)))


# ---------------------------------------------------------------------------
# the bitset route's blocking, in plain PyTorch (a model for the tests)
# ---------------------------------------------------------------------------

LANES = 32                      # rows of a warp sub-chunk, tags of a word
PASS_ROWS = 256                 # rows of one pass of the bitset kernel
_FULL = (1 << LANES) - 1


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value it wraps to (two's complement)."""
    return torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """(..., 32) 0/1 planes of 32-bit words."""
    return (x.unsqueeze(-1) >> torch.arange(LANES, device=x.device)) & 1


def _popc(x: torch.Tensor) -> torch.Tensor:
    return _bits(x).sum(-1)


def _highest(x: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of each word, -1 for 0."""
    return (_bits(x) * torch.arange(1, LANES + 1, device=x.device)).amax(
        -1) - 1


def _scan(x: torch.Tensor, op, up: bool) -> torch.Tensor:
    """Inclusive scan over the last axis by doubling steps, as a warp's
    shuffles take it (lanes past the edge contribute 0, the identity of
    both | and +)."""
    o = 1
    while o < x.shape[-1]:
        pad = (o, 0) if up else (0, o)
        part = x[..., :-o] if up else x[..., o:]
        x = op(x, torch.nn.functional.pad(part, pad))
        o *= 2
    return x


def _shift(x: torch.Tensor, up: bool) -> torch.Tensor:
    """Each lane takes its neighbour's value (below if `up`), 0 at the
    edge: the exclusive form of an inclusive scan."""
    return torch.nn.functional.pad(x[..., :-1] if up else x[..., 1:],
                                   (1, 0) if up else (0, 1))


def _or_words(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR of 32-bit words along `dim` (counted before the bit
    axis is appended)."""
    return (_bits(x).amax(dim) << torch.arange(LANES, device=x.device)).sum(
        -1)


def _bit(word: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return ((word >> idx.clamp(min=0)) & 1).bool()


def window_loop_bitset_plain(ptags: torch.Tensor, pcosts: torch.Tensor,
                             cell_fleet: torch.Tensor,
                             num_active: torch.Tensor,
                             miss_latency: torch.Tensor,
                             quanta: torch.Tensor, schedule: torch.Tensor,
                             handler, bs_extra, init: Carry, *,
                             total_steps: int, window: int, pos_base: int,
                             materialise: bool, pass_rows: int = PASS_ROWS,
                             stats: list | None = None) -> Carry:
    """The bitset route of `csrc/window_distance.cu`, step for step, in
    plain PyTorch: the same arguments and results as `window_loop_plain`
    (num_tags <= 32).  The tests hold it to that function bit for bit; the
    card runs the kernel it models.

    Every Python trip is one pass of `pass_rows` rows (warps of 32) for
    every cell still running.  A tag set is a 32-bit word (held in int64).
    Per warp: `match_any` gives each row the rows of its tag, the previous
    in-warp occurrence is the highest of them below the row, and a row
    whose previous occurrence is in its warp takes its stack distance as
    the popcount of the warp's live rows after that occurrence (live: the
    last occurrence of its tag so far, from an exclusive OR-scan of
    `1 << prev`).  Any other row takes it as the popcount of one word: the
    tags newer than its tag's last occurrence before the warp (the
    carried newer-than set `N_t = {u : last_pos[u] > last_pos[t]}`,
    replaced by a warp's suffix set wherever an earlier warp of the pass
    holds the tag, ORed with each later earlier warp's tag set) ORed with
    the tags of the rows before it in its warp.  Costs are summed by warp
    scans plus the warps' totals; the cut is the first warp holding an
    expiry, at its first expiring row.  The commit writes each tag's last
    committed position (and newer-than set) from the one row that is its
    final committed occurrence, and ORs the pass's committed tags into the
    newer-than set of every tag it did not touch.  `stats`, when given,
    receives one (trips, passes) pair per cell."""
    dev = ptags.device
    _, num_progs, trace_len = ptags.shape
    num_tags = init.last_pos.shape[1]
    if not 1 <= num_tags <= LANES or pass_rows % LANES:
        raise ValueError(f"the bitset route takes 1..{LANES} tags and "
                         f"passes of whole warps, got {num_tags} tags, "
                         f"{pass_rows} rows")
    cells = cell_fleet.shape[0]
    nw = pass_rows // LANES
    sched_len = schedule.shape[0]
    lane = torch.arange(LANES, device=dev)
    lt = (1 << lane) - 1                        # lanes below each lane
    gt = _FULL & ~((2 << lane) - 1)             # lanes above each lane
    warps = torch.arange(nw, device=dev)
    rows_in_pass = torch.arange(pass_rows, device=dev)
    row_off = (warps * LANES)[:, None] + lane   # (nw, 32)
    flat_tags = ptags.reshape(-1).long()
    flat_costs = pcosts.reshape(-1).long()
    row_base = cell_fleet.long() * num_progs
    i64 = lambda x: x.to(torch.int64)
    pad32 = lambda x, v: torch.nn.functional.pad(
        i64(x), (0, LANES - num_tags), value=v)
    lp, lm = pad32(init.last_pos, -1), pad32(init.last_miss, -1)
    # carried newer-than sets: bit v of nset[c, u] iff lp[c, v] > lp[c, u]
    nset = ((lp[:, None, :] > lp[:, :, None]).long() << lane).sum(-1)
    cursors, cycles = i64(init.cursors), i64(init.cycles)
    instrs, misses, bsm = i64(init.instrs), i64(init.misses), i64(
        init.bs_misses)
    sched_idx, q_cycles = i64(init.sched_idx), i64(init.q_cycles)
    switches = i64(init.switches)
    steps = torch.zeros(cells, dtype=torch.int64, device=dev)
    lat, nact = i64(miss_latency), i64(num_active)
    handler, bs_extra = int(handler), int(bs_extra)
    # per-trip state; base == 0 opens a trip
    base = torch.zeros_like(steps)
    p = start = limit = quantum = running = committed = n_miss = n_cold = (
        torch.zeros_like(steps))
    trips = torch.zeros_like(steps)
    passes = torch.zeros_like(steps)
    while True:
        active = steps < total_steps
        if not bool(active.any()):
            break
        opening = base == 0
        p_new = i64(schedule[sched_idx.long()])
        p = torch.where(opening, p_new, p)
        start = torch.where(opening, torch.remainder(
            cursors.gather(1, p[:, None])[:, 0], trace_len), start)
        limit = torch.where(opening, torch.clamp(total_steps - steps,
                                                 max=window), limit)
        quantum = torch.where(opening, i64(quanta).gather(1, p[:, None])[
            :, 0], quantum)
        running = torch.where(opening, q_cycles, running)
        zero = torch.zeros_like(steps)
        committed = torch.where(opening, zero, committed)
        n_miss = torch.where(opening, zero, n_miss)
        n_cold = torch.where(opening, zero, n_cold)

        # the pass's rows, read as the kernel reads its ring
        rows = torch.clamp(limit - base, max=pass_rows)
        valid = rows_in_pass < rows[:, None]
        idx = torch.remainder(start[:, None] + base[:, None] + rows_in_pass,
                              trace_len)
        flat = (row_base + p)[:, None] * trace_len + idx
        t = torch.where(valid, flat_tags[flat], -1).view(cells, nw, LANES)
        h = torch.where(valid, flat_costs[flat], 0).view(cells, nw, LANES)
        valid = valid.view(cells, nw, LANES)
        pos0 = pos_base + steps + base

        # phase 1, per warp: tag words, previous in-warp occurrences,
        # scans; each warp publishes its tag set and, per tag present,
        # the tags after its last occurrence
        tagged = t >= 0
        tsafe = t.clamp(min=0)
        b = torch.where(tagged, 1 << tsafe, 0)
        mm = ((t[..., :, None] == t[..., None, :]).long() << lane).sum(-1)
        k = torch.where(tagged, _highest(mm & lt), -1)
        kb = torch.where(k >= 0, 1 << k.clamp(min=0), 0)
        pb = _scan(b, torch.bitwise_or, True)
        killed = _shift(_scan(kb, torch.bitwise_or, True), True)
        suf = _shift(_scan(b, torch.bitwise_or, False), False)
        pref = _shift(pb, True)
        wset = pb[..., LANES - 1]                            # (C, nw)
        tagmask = (tagged.long() << lane).sum(-1)            # ballot
        last = tagged & ((mm & gt) == 0)
        nwtab = torch.zeros((cells, nw, LANES + 1), dtype=torch.int64,
                            device=dev)
        nwtab.scatter_(2, torch.where(last, t, LANES), suf)
        nwtab = nwtab[..., :LANES]
        live = lt & tagmask[..., None] & ~killed
        dist_in = _popc(live & (torch.full_like(k, _FULL) << (k + 1).clamp(
            min=0)) & _FULL)

        # phase 2, per (warp, tag): the newer-than word of each tag's last
        # occurrence before the warp, and whether the tag is cold there
        nb = nset[:, None, :].expand(cells, nw, LANES).clone()
        seen = torch.zeros((cells, nw, LANES), dtype=torch.bool, device=dev)
        for x in range(nw - 1):
            wx = wset[:, x]
            pres = ((wx[:, None] >> lane) & 1).bool()        # (C, 32)
            nb[:, x + 1:] = torch.where(pres[:, None, :],
                                        nwtab[:, x, None, :],
                                        nb[:, x + 1:] | wx[:, None, None])
            seen[:, x + 1:] |= pres[:, None, :]
        cold_u = ~seen & (lp[:, None, :] < 0)
        in_warp = k >= 0
        dist = torch.where(in_warp, dist_in,
                           _popc(nb.gather(2, tsafe) | pref))
        cold = tagged & ~in_warp & cold_u.gather(2, tsafe)
        miss = tagged & (cold | (dist >= nact[:, None, None]))
        cost = torch.where(valid, h + miss * lat[:, None, None]
                           + cold * bs_extra, 0)
        incl = _scan(cost, torch.add, True)
        tot = incl[..., LANES - 1]                           # (C, nw)

        # phase 3, per warp: cumulative cost, its first expiry, and what
        # the commit needs from the lanes up to it
        offs = torch.cumsum(tot, 1) - tot
        cum = _wrap32(running[:, None, None] + offs[..., None] + incl)
        expire = valid & (cum >= quantum[:, None, None])
        f = torch.where(expire.any(-1), expire.long().argmax(-1), LANES)
        le = lane <= f[..., None]
        mcnt = (miss & le).sum(-1)
        ccnt = (cold & le).sum(-1)
        rw = _or_words(torch.where(le, b, 0), -2)
        rmw = _or_words(torch.where(le & miss, b, 0), -2)
        endc = cum.gather(2, f.clamp(max=LANES - 1)[..., None])[..., 0]

        # phase 4: the cut, the commit, the trip's bookkeeping
        expm = f < LANES
        expiry = expm.any(1)
        wc = torch.where(expiry, expm.long().argmax(1), nw - 1)
        inr = warps <= wc[:, None]                           # (C, nw)
        rwx = torch.where(inr, rw, 0)
        rmwx = torch.where(inr, rmw, 0)
        touched = _or_words(rwx, -2)
        later = _shift(_scan(rwx, torch.bitwise_or, False), False)
        later_m = _shift(_scan(rmwx, torch.bitwise_or, False), False)
        f_wc = f.gather(1, wc[:, None])[:, 0]
        cut = torch.where(expiry, wc * LANES + f_wc + 1, rows)
        end_cum = torch.where(expiry, endc.gather(1, wc[:, None])[:, 0],
                              _wrap32(running + tot.sum(1)))
        f_own = torch.where(expiry[:, None] & (warps == wc[:, None]), f,
                            LANES)
        leo = lane <= f_own[..., None]
        leo_w = (leo.long() << lane).sum(-1)[..., None]
        rsuf = _shift(_scan(torch.where(leo, b, 0), torch.bitwise_or,
                            False), False)
        comm = valid & leo & inr[..., None]
        rowpos = pos0[:, None, None] + row_off
        writer = (comm & tagged & ((mm & gt & leo_w) == 0)
                  & ~_bit(later[..., None], t))
        touched_u = ((touched[:, None] >> lane) & 1).bool()  # (C, 32)
        lp_w = torch.zeros((cells, LANES + 1), dtype=torch.int64, device=dev)
        ns_w = torch.zeros_like(lp_w)
        dst = torch.where(writer, t, LANES).view(cells, -1)
        lp_w.scatter_(1, dst, rowpos.reshape(cells, -1))
        ns_w.scatter_(1, dst, (rsuf | later[..., None]).reshape(cells, -1))
        lp_new = torch.where(touched_u, lp_w[:, :LANES], lp)
        nset_new = torch.where(touched_u, ns_w[:, :LANES],
                               nset | touched[:, None])
        lm_new = lm
        if materialise:
            missw = (miss.long() << lane).sum(-1)[..., None]
            mwriter = (comm & miss & ((mm & missw & gt & leo_w) == 0)
                       & ~_bit(later_m[..., None], t))
            lm_w = torch.zeros_like(lp_w)
            lm_w.scatter_(1, torch.where(mwriter, t, LANES).view(cells, -1),
                          rowpos.reshape(cells, -1))
            missed_u = ((_or_words(rmwx, -2)[:, None] >> lane) & 1).bool()
            lm_new = torch.where(missed_u, lm_w[:, :LANES], lm)
        committed_new = committed + cut
        n_miss_new = n_miss + (mcnt * inr).sum(1)
        n_cold_new = n_cold + (ccnt * inr).sum(1)
        base_new = base + pass_rows
        trip_end = expiry | (base_new >= limit)

        onehot = (torch.arange(num_progs, device=dev) == p[:, None]).long()
        end = (active & trip_end)[:, None]
        run_cycles = _wrap32(end_cum - q_cycles + expiry.long() * handler)
        a2 = active[:, None]
        lp = torch.where(a2, lp_new, lp)
        lm = torch.where(a2, lm_new, lm)
        nset = torch.where(a2, nset_new, nset)
        cursors = torch.where(end, cursors + onehot * committed_new[:, None],
                              cursors)
        cycles = torch.where(end, _wrap32(cycles + onehot
                                          * run_cycles[:, None]), cycles)
        instrs = torch.where(end, instrs + onehot * committed_new[:, None],
                             instrs)
        misses = torch.where(end, misses + onehot * n_miss_new[:, None],
                             misses)
        bsm = torch.where(end, bsm + onehot * n_cold_new[:, None], bsm)
        end = end[:, 0]
        sched_idx = torch.where(end & expiry, (sched_idx + 1) % sched_len,
                                sched_idx)
        steps = torch.where(end, steps + committed_new, steps)
        q_cycles = torch.where(end, torch.where(expiry, 0, end_cum),
                               q_cycles)
        switches = torch.where(end, switches + expiry.long(), switches)
        trips = trips + end.long()
        passes = passes + active.long()
        running = torch.where(active, end_cum, running)
        committed = torch.where(active, committed_new, committed)
        n_miss = torch.where(active, n_miss_new, n_miss)
        n_cold = torch.where(active, n_cold_new, n_cold)
        base = torch.where(active & ~trip_end, base_new, 0)
    if stats is not None:
        stats.extend(zip(trips.tolist(), passes.tolist()))
    i32 = lambda x: x.to(torch.int32)
    return Carry(last_pos=i32(lp[:, :num_tags]),
                 last_miss=i32(lm[:, :num_tags]), cursors=i32(cursors),
                 sched_idx=i32(sched_idx), steps_done=i32(steps),
                 q_cycles=i32(q_cycles), cycles=i32(cycles),
                 instrs=i32(instrs), misses=i32(misses),
                 bs_misses=i32(bsm), switches=i32(switches))


def _grid_cells(nq: int, nb: int, nk: int, nl: int, device):
    """(Q, B, K, L) row-major cell coordinates, each (C,) long."""
    q, b, k, l = torch.meshgrid(
        *(torch.arange(n, device=device) for n in (nq, nb, nk, nl)),
        indexing="ij")
    return q.reshape(-1), b.reshape(-1), k.reshape(-1), l.reshape(-1)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def window_grid_plain(ptags, pcosts, slot_counts, miss_latencies, quanta,
                      schedule, handler, bs_miss_extra, *, num_tags: int,
                      total_steps: int, window: int):
    """Plain version of `window_grid` (same signature and results)."""
    dev = ptags.device
    nb, num_progs, _ = ptags.shape
    counts = _i32(slot_counts, dev).reshape(-1)
    lats = _i32(miss_latencies, dev).reshape(-1)
    quanta = _i32(quanta, dev)
    nq, nk, nl = quanta.shape[0], counts.shape[0], lats.shape[0]
    q, b, k, l = _grid_cells(nq, nb, nk, nl, dev)
    final = window_loop_plain(
        ptags, pcosts, b, counts[k], lats[l], quanta[q],
        _i32(schedule, dev).reshape(-1), handler, bs_miss_extra,
        cold_carry(q.shape[0], num_progs, num_tags, dev),
        total_steps=int(total_steps), window=int(window), pos_base=0,
        materialise=False)
    pshape = (nq, nb, nk, nl, num_progs)
    return (final.cycles.reshape(pshape), final.instrs.reshape(pshape),
            final.misses.reshape(pshape), final.bs_misses.reshape(pshape),
            final.switches.reshape(pshape[:-1]))


def _seed_carry(seed, num_progs: int, num_tags: int, device) -> Carry:
    if seed is None:
        return cold_carry(1, num_progs, num_tags, device)
    (s_last, s_cursors, s_sched, s_qc, s_cycles, s_instrs, s_misses,
     s_bsm, s_switches) = seed
    v = lambda x: _i32(x, device).reshape(1, -1)
    s = lambda x: _i32(x, device).reshape(1)
    return Carry(last_pos=v(s_last),
                 last_miss=torch.full((1, num_tags), -1, dtype=torch.int32,
                                      device=device),
                 cursors=v(s_cursors), sched_idx=s(s_sched),
                 steps_done=torch.zeros(1, dtype=torch.int32, device=device),
                 q_cycles=s(s_qc), cycles=v(s_cycles), instrs=v(s_instrs),
                 misses=v(s_misses), bs_misses=v(s_bsm),
                 switches=s(s_switches))


def window_cell_plain(ptags, pcosts, num_active, miss_latency, quanta,
                      schedule, handler, bs_miss_extra, seed=None, *,
                      num_tags: int, total_steps: int, window: int,
                      seeded: bool | None = None, materialise: bool = True):
    """Plain version of `window_cell` (same signature and results)."""
    if seeded is None:
        seeded = seed is not None
    dev = ptags.device
    num_progs = ptags.shape[0]
    final = window_loop_plain(
        ptags[None], pcosts[None], torch.zeros(1, dtype=torch.long,
                                               device=dev),
        _i32(num_active, dev).reshape(1), _i32(miss_latency, dev).reshape(1),
        _i32(quanta, dev).reshape(1, num_progs),
        _i32(schedule, dev).reshape(-1), handler, bs_miss_extra,
        _seed_carry(seed, num_progs, num_tags, dev),
        total_steps=int(total_steps), window=int(window),
        pos_base=num_tags if seeded else 0, materialise=bool(materialise))
    return tuple(x[0] for x in final)


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def build(verbose: bool = False) -> str:
    """Compile `csrc/window_distance.cu` into `kernels/build/` (once per
    source content) and return the shared library's path."""
    return common.build(SOURCE, verbose)


def route(num_tags: int, num_progs: int) -> str:
    """The route the kernel's C entry point takes for these shapes
    (`bitset_route` in `csrc/window_distance.cu`): "bitset" while a tag
    set fits one 32-bit word and a warp's lanes hold the fleet's
    programs, else "generic".  The wrappers check the route the entry
    point reports against it."""
    return ("bitset" if num_tags <= LANES and num_progs <= LANES
            else "generic")


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.window_distance_launch.argtypes = [vp] * 13 + [ci] * 14 + [vp] * 3
    lib.window_distance_launch.restype = ci
    lib.window_distance_smem_bytes.argtypes = [ci] * 5
    lib.window_distance_smem_bytes.restype = ctypes.c_size_t


def _library():
    return common.library(SOURCE, _declare)


def _check(name: str, t: torch.Tensor, shape: tuple,
           device: torch.device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected torch.int32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t


def _ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


@common.on_tensor_device
def _launch(ptags, pcosts, counts, lats, quanta, schedule, seed, *,
            handler: int, bs_extra: int, num_tags: int, total_steps: int,
            window: int, pos_base: int, materialise: bool,
            want_tags: bool, stats: list | None):
    """Check the operands, allocate the outputs and launch the kernel on
    the current stream.  Returns (out_vec (C,5,P), out_sca (C,4),
    out_last (C,T) | None, out_miss (C,T) | None, route).  `stats`, when
    given, receives one (trips, passes) pair per cell from the bitset
    route (reading them synchronises; (-1, -1) on the generic route)."""
    dev = ptags.device
    nb, num_progs, trace_len = ptags.shape
    nq, nk, nl = quanta.shape[0], counts.shape[0], lats.shape[0]
    sched_len = schedule.shape[0]
    if min(num_progs, trace_len, sched_len, num_tags, window) < 1:
        raise ValueError("window kernel needs P, N, S, num_tags and window "
                         ">= 1")
    _check("ptags", ptags, (nb, num_progs, trace_len), dev)
    _check("pcosts", pcosts, (nb, num_progs, trace_len), dev)
    _check("slot_counts", counts, (nk,), dev)
    _check("miss_latencies", lats, (nl,), dev)
    _check("quanta", quanta, (nq, num_progs), dev)
    _check("schedule", schedule, (sched_len,), dev)
    lib = _library()
    want = route(num_tags, num_progs)
    smem = lib.window_distance_smem_bytes(num_tags, num_progs, int(window),
                                          int(total_steps), sched_len)
    if smem > _SMEM_LIMIT:
        what = (f"the bitset route's stream rings for P={num_progs} at "
                f"window={min(window, max(total_steps, 1))}"
                if want == "bitset" else
                f"num_tags={num_tags} with P={num_progs}")
        raise ValueError(
            f"{what} need {smem} bytes of shared memory per block, above "
            f"the {_SMEM_LIMIT} a Hopper block holds")
    if seed is not None:
        s_last, s_vec, s_sca = seed
        _check("seed last_pos", s_last, (num_tags,), dev)
        _check("seed vectors", s_vec, (5, num_progs), dev)
        _check("seed scalars", s_sca, (3,), dev)
    cells = nq * nb * nk * nl
    out_vec = torch.empty((cells, 5, num_progs), dtype=torch.int32,
                          device=dev)
    out_sca = torch.empty((cells, 4), dtype=torch.int32, device=dev)
    out_last = out_miss = None
    if want_tags:
        out_last = torch.empty((cells, num_tags), dtype=torch.int32,
                               device=dev)
        out_miss = torch.empty_like(out_last)
    out_stats = (torch.full((cells, 2), -1, dtype=torch.int32, device=dev)
                 if stats is not None else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    got = ctypes.c_int(-1)
    err = lib.window_distance_launch(
        _ptr(ptags), _ptr(pcosts), _ptr(counts), _ptr(lats), _ptr(quanta),
        _ptr(schedule), *(_ptr(x) for x in (seed or (None,) * 3)),
        _ptr(out_vec), _ptr(out_sca), _ptr(out_last), _ptr(out_miss),
        nb, num_progs, trace_len, nq, nk, nl, sched_len, num_tags,
        int(handler), int(bs_extra), int(total_steps), int(window),
        int(pos_base), int(bool(materialise)), ctypes.c_void_p(stream),
        _ptr(out_stats), ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"window kernel launch failed: CUDA error {err}")
    taken = ROUTES[0] if got.value == 1 else ROUTES[1]
    if taken != want:
        raise RuntimeError(f"window kernel took the {taken} route where "
                           f"`route` says {want}")
    if stats is not None:
        stats.extend(map(tuple, out_stats.tolist()))
    return out_vec, out_sca, out_last, out_miss, taken


def cost(stream_elems: int, cells: int, total_steps: int, num_tags: int,
         num_progs: int, *, cell: bool = False) -> dict:
    """The kernel's count (`analysis.cost.work`) for `cells` cells of
    `total_steps` committed accesses each: 2 num_tags + 8 int32 operations
    an access (the stack-distance compares and the per-tag last-position
    update, the cost, scan, expiry and counter arithmetic); each tag/cost
    element read once (at most the whole streams, at most one per
    access), and the outputs (a grid's four program vectors and switch
    count a cell; a cell's two tag vectors, five program vectors and four
    scalars, and as much seed) written once."""
    accesses = cells * total_steps
    other = (4 * 2 * (num_tags + 5 * num_progs + 4) if cell
             else 4 * cells * (4 * num_progs + 1))
    return _cost.work(accesses * (2 * num_tags + 8), "int",
                      8 * min(stream_elems, accesses) + other)


def _grid_work(ptags, slot_counts, miss_latencies, quanta, num_tags: int,
               total_steps: int) -> dict:
    n = lambda x: torch.as_tensor(x).numel()
    cells = (n(quanta) // ptags.shape[1]) * ptags.shape[0] * \
        n(slot_counts) * n(miss_latencies)
    return cost(ptags.numel(), cells, total_steps, num_tags,
                ptags.shape[1])


def _cell_work(ptags, num_tags: int, total_steps: int) -> dict:
    return cost(ptags.numel(), 1, total_steps, num_tags, ptags.shape[0],
                cell=True)


def window_grid(ptags, pcosts, slot_counts, miss_latencies, quanta,
                schedule, handler, bs_miss_extra, *, num_tags: int,
                total_steps: int, window: int, stats: list | None = None):
    """One-shot counter sweep: (B, P, N) pre-gathered tag/cost streams ->
    (cycles, instrs, misses, bs_misses) as (Q, B, K, L, P) int32 and
    switches as (Q, B, K, L), one cell per point of the (Q, B, K, L) grid.

    CUDA tensors launch the kernel (one CTA per cell) and count it in
    `window_grid.launches` and `window_grid.routes`; CPU tensors run
    `window_grid_plain`.  `stats` (CUDA) receives each cell's (trips,
    passes) from the bitset route, as `window_loop_bitset_plain` counts
    them.
    `handler` and `bs_miss_extra` are Python ints (a 0-d tensor is read
    back to the host)."""
    if ptags.device.type != "cuda":
        with _cost.kernel("window_grid", lambda: _grid_work(
                ptags, slot_counts, miss_latencies, quanta, num_tags,
                total_steps)):
            return window_grid_plain(
                ptags, pcosts, slot_counts, miss_latencies, quanta,
                schedule, handler, bs_miss_extra, num_tags=num_tags,
                total_steps=total_steps, window=window)
    dev = ptags.device
    nb, num_progs, _ = ptags.shape
    counts = _i32(slot_counts, dev).reshape(-1)
    lats = _i32(miss_latencies, dev).reshape(-1)
    quanta = _i32(quanta, dev)
    with _cost.kernel("window_grid", lambda: _grid_work(
            ptags, counts, lats, quanta, num_tags, total_steps)):
        out_vec, out_sca, _, _, taken = _launch(
            ptags, pcosts, counts, lats, quanta,
            _i32(schedule, dev).reshape(-1), None, handler=int(handler),
            bs_extra=int(bs_miss_extra), num_tags=num_tags,
            total_steps=total_steps, window=window, pos_base=0,
            materialise=False, want_tags=False, stats=stats)
    window_grid.launches += 1
    window_grid.routes[taken] += 1
    shape = (quanta.shape[0], nb, counts.shape[0], lats.shape[0])
    pshape = shape + (num_progs,)
    return (out_vec[:, 1].reshape(pshape), out_vec[:, 2].reshape(pshape),
            out_vec[:, 3].reshape(pshape), out_vec[:, 4].reshape(pshape),
            out_sca[:, 3].reshape(shape))


window_grid.launches = 0
window_grid.routes = dict.fromkeys(ROUTES, 0)


def window_cell(ptags, pcosts, num_active, miss_latency, quanta, schedule,
                handler, bs_miss_extra, seed=None, *, num_tags: int,
                total_steps: int, window: int, seeded: bool | None = None,
                materialise: bool = True, stats: list | None = None):
    """One cell: (P, N) streams (+ optional engine-coordinate seed) -> the
    11 `CellCarry` fields in declaration order.  `seed` is (last_pos,
    cursors, sched_idx, q_cycles, cycles, instrs, misses, bs_misses,
    switches); None starts cold.  Seeded runs place segment positions at
    `pos_base = num_tags`, above the seed's virtual block.

    CUDA tensors launch the kernel (one CTA) and count it in
    `window_cell.launches` and `window_cell.routes`; CPU tensors run
    `window_cell_plain`.  `stats` as in `window_grid`."""
    if ptags.device.type != "cuda":
        with _cost.kernel("window_cell", lambda: _cell_work(
                ptags, num_tags, total_steps)):
            return window_cell_plain(
                ptags, pcosts, num_active, miss_latency, quanta, schedule,
                handler, bs_miss_extra, seed, num_tags=num_tags,
                total_steps=total_steps, window=window, seeded=seeded,
                materialise=materialise)
    if seeded is None:
        seeded = seed is not None
    dev = ptags.device
    num_progs = ptags.shape[0]
    kseed = None
    if seed is not None:
        (s_last, s_cursors, s_sched, s_qc, s_cycles, s_instrs, s_misses,
         s_bsm, s_switches) = seed
        kseed = (_i32(s_last, dev).reshape(-1).contiguous(),
                 torch.stack([_i32(x, dev).reshape(-1) for x in
                              (s_cursors, s_cycles, s_instrs, s_misses,
                               s_bsm)]),
                 torch.stack([_i32(x, dev).reshape(()) for x in
                              (s_sched, s_qc, s_switches)]))
    with _cost.kernel("window_cell", lambda: _cell_work(
            ptags, num_tags, total_steps)):
        out_vec, out_sca, out_last, out_miss, taken = _launch(
            ptags[None].contiguous(), pcosts[None].contiguous(),
            _i32(num_active, dev).reshape(1),
            _i32(miss_latency, dev).reshape(1),
            _i32(quanta, dev).reshape(1, num_progs).contiguous(),
            _i32(schedule, dev).reshape(-1).contiguous(), kseed,
            handler=int(handler), bs_extra=int(bs_miss_extra),
            num_tags=num_tags, total_steps=total_steps, window=window,
            pos_base=num_tags if seeded else 0, materialise=materialise,
            want_tags=True, stats=stats)
    window_cell.launches += 1
    window_cell.routes[taken] += 1
    v, s = out_vec[0], out_sca[0]
    return (out_last[0], out_miss[0], v[0], s[0], s[1], s[2], v[1], v[2],
            v[3], v[4], s[3])


window_cell.launches = 0
window_cell.routes = dict.fromkeys(ROUTES, 0)
