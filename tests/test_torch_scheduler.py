"""The port's scheduling policy, host KV tier and fault streams, held
against the reference on the CPU.

- ``SwapCostModel``: the reference's cases (break-even on long contexts, a
  slow link, unswappable victims, monotone and chunked, the spec adopted,
  a calibration that moves the device side only, an explicit link scale)
  with the same numbers through both models, the port's spec carrying the
  reference's HBM rate; the port's defaults are the H100's (its spec and
  its 64 GB/s PCIe Gen5 x16 host link);
- ``Scheduler``: queue order, ``prefill_order`` with its cap and its
  refusal of caps below 1, ``pick_victim`` with and without a cost model,
  on the reference's cases and on hypothesis-drawn candidate sets;
- ``HostKVTier``: round trip, padding pages outside the checksum,
  corruption caught, ``put_entry`` verbatim, ``bytes_in`` only for
  verified gets, the checksummed span, ``page_axis``'s refusal, a bf16
  pool's checksum over raw bytes, and the gathered tree's leaves in the
  reference's flatten order;
- ``fault_rng``: every fault kind's stream equal to the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.memmodel import TPUSpec
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import SwapCostModel as JCost
from repro.serve import fault_rng as j_fault_rng
from repro.serve.chaos import _FAULT_KIND_IDS as J_KINDS
from repro.serve.scheduler import VictimInfo as JVictim
from repro_torch.core.memmodel import H100, HopperSpec
from repro_torch.serve import (HostKVTier, Request, Scheduler,
                               SchedulerConfig, SwapCostModel, corrupt_entry,
                               fault_rng, make_transfer_entry)
from repro_torch.serve.chaos import _FAULT_KIND_IDS as T_KINDS
from repro_torch.serve.hosttier import checksum_pages, page_axis, tree_leaves
from repro_torch.serve.scheduler import HOST_LINK_BW, VictimInfo

# the reference's production-ish numbers: 2.5B bf16 params, gemma-2b KV
# row, a 256-token chunk
PROD = dict(weight_bytes=5e9, kv_bytes_per_token=18_432, prefill_chunk=256)
V5E_BW = TPUSpec().hbm_bw


def _models(hbm_bw=V5E_BW, **kw):
    """(reference model, port model) on the same numbers."""
    link = kw.pop("host_link_bw", 32e9)
    return (JCost(**PROD, spec=TPUSpec(hbm_bw=hbm_bw), host_link_bw=link,
                  **kw),
            SwapCostModel(**PROD, spec=HopperSpec(hbm_bw=hbm_bw),
                          host_link_bw=link, **kw))


# ---------------------------------------------------------------------------
# SwapCostModel
# ---------------------------------------------------------------------------

CTXS = [1, 63, 64, 65, 255, 256, 257, 512, 1024, 4096, 8192]


@pytest.mark.parametrize("link", [32e9, 1e6, 64e9])
def test_cost_model_matches_reference(link):
    jcm, tcm = _models(host_link_bw=link)
    for ctx in CTXS:
        assert tcm.recompute_s(ctx) == jcm.recompute_s(ctx)
        assert tcm.swap_s(ctx) == jcm.swap_s(ctx)
        for swappable in (False, True):
            assert (tcm.resume_s(ctx, swappable)
                    == jcm.resume_s(ctx, swappable))
            assert tcm.choose(ctx, swappable) == jcm.choose(ctx, swappable)


def test_cost_model_swap_beats_recompute_on_long_ctx():
    cm = SwapCostModel(**PROD)
    assert cm.swap_s(8192) < cm.recompute_s(8192)
    assert cm.choose(8192, swappable=True) == "swap"
    r1 = cm.recompute_s(1024) / cm.swap_s(1024)
    r8 = cm.recompute_s(8192) / cm.swap_s(8192)
    assert r8 >= r1 > 1.0


def test_cost_model_slow_link_prefers_recompute():
    cm = SwapCostModel(**PROD, host_link_bw=1e6)
    assert cm.choose(4096, swappable=True) == "recompute"
    assert cm.resume_s(4096, swappable=True) == cm.recompute_s(4096)


def test_cost_model_unswappable_always_recomputes():
    cm = SwapCostModel(**PROD)
    assert cm.choose(8192, swappable=False) == "recompute"
    assert cm.resume_s(8192, swappable=False) == cm.recompute_s(8192)


def test_cost_model_monotonic_and_chunked():
    cm = SwapCostModel(weight_bytes=1e9, kv_bytes_per_token=1e4,
                       prefill_chunk=64)
    xs = [1, 63, 64, 65, 512, 4096]
    rec = [cm.recompute_s(x) for x in xs]
    swp = [cm.swap_s(x) for x in xs]
    assert rec == sorted(rec) and swp == sorted(swp)
    bump = cm.recompute_s(65) - cm.recompute_s(64)
    assert bump > 0.9 * 1e9 / cm.spec.hbm_bw


def test_cost_model_defaults_are_the_cards():
    cm = SwapCostModel(**PROD)
    assert cm.spec == H100 and cm.host_link_bw == HOST_LINK_BW == 64e9
    assert SchedulerConfig().host_link_bw == HOST_LINK_BW
    # with H100's 3.35 TB/s a 256-token chunk of 5 GB of weights takes
    # 1.49 ms; the two link crossings of its 256 KV rows 0.15 ms
    assert cm.recompute_s(256) == pytest.approx((5e9 + 256 * 18_432)
                                                / 3.35e12)
    assert cm.swap_s(256) == pytest.approx(2 * 256 * 18_432 / 64e9)


def test_cost_model_adopts_spec():
    fast = SwapCostModel(**PROD, spec=HopperSpec(hbm_bw=2 * 3.35e12))
    slow = SwapCostModel(**PROD, spec=HopperSpec(hbm_bw=3.35e12))
    assert fast.recompute_s(4096) < slow.recompute_s(4096)
    assert fast.swap_s(4096) == slow.swap_s(4096)     # link, not HBM


def _calibrations(scale, base_bw=V5E_BW):
    """(reference, port) calibration results whose fitted spec scales the
    base HBM rate by ``scale``."""
    from repro.bench.calibrate import CalibrationResult as JCal
    from repro_torch.bench.calibrate import CalibrationResult as TCal

    jbase, tbase = TPUSpec(hbm_bw=base_bw), HopperSpec(hbm_bw=base_bw)
    return (JCal(spec=dataclasses.replace(jbase, hbm_bw=base_bw * scale),
                 base_spec=jbase, rms_log_error=0.0, n_samples=8),
            TCal(spec=dataclasses.replace(tbase, hbm_bw=base_bw * scale),
                 base_spec=tbase, rms_log_error=0.0, n_samples=8))


@pytest.mark.parametrize("link_scale", [None, 0.5])
def test_calibration_moves_the_device_side_only(link_scale):
    jcal, tcal = _calibrations(2.0)
    assert tcal.bandwidth_scale == jcal.bandwidth_scale == 2.0
    jcm, tcm = _models(calibration=None, link_scale=None)
    jcald, tcald = (
        JCost(**PROD, spec=TPUSpec(hbm_bw=V5E_BW), calibration=jcal,
              link_scale=link_scale),
        SwapCostModel(**PROD, spec=HopperSpec(hbm_bw=V5E_BW),
                      host_link_bw=32e9, calibration=tcal,
                      link_scale=link_scale))
    assert tcald.spec.hbm_bw == 2 * V5E_BW == jcald.spec.hbm_bw
    assert tcald.host_link_bw == jcald.host_link_bw
    assert tcald.recompute_s(4096) == pytest.approx(tcm.recompute_s(4096) / 2)
    want = 1.0 if link_scale is None else 1 / link_scale
    assert tcald.swap_s(4096) == pytest.approx(want * tcm.swap_s(4096))
    for ctx in CTXS:
        assert tcald.recompute_s(ctx) == jcald.recompute_s(ctx)
        assert tcald.swap_s(ctx) == jcald.swap_s(ctx)


def test_calibrated_break_even_pinned_under_nonunity_scale():
    # between the right break-even and the one an HBM-rescaled link gives
    _, tcal = _calibrations(2.0, base_bw=100e9)
    cm = SwapCostModel(weight_bytes=1.28e6, kv_bytes_per_token=1e4,
                       prefill_chunk=64, spec=HopperSpec(hbm_bw=100e9),
                       host_link_bw=1e11, calibration=tcal)
    assert cm.host_link_bw == 1e11
    assert cm.choose(4096, swappable=True) == "recompute"


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------

def _queue(R, pairs):
    return [R(rid=rid, prompt=np.zeros((4,), np.int32), priority=p)
            for rid, p in pairs]


@pytest.mark.parametrize("pairs,arrival", [
    ([(0, 0), (1, 1), (2, 0), (3, 1)], {0: 0, 1: 1, 2: 2, 3: 3}),
    ([(7, 0), (2, 0)], {2: 0, 7: 5}),        # a preempted rid keeps its seat
    ([(4, 2), (5, 0), (6, 2), (8, 1)], {4: 3, 6: 1}),   # missing seats: 0
])
def test_order_queue_matches_reference(pairs, arrival):
    jq, tq = _queue(JRequest, pairs), _queue(Request, pairs)
    JScheduler().order_queue(jq, arrival)
    Scheduler().order_queue(tq, arrival)
    assert [r.rid for r in tq] == [r.rid for r in jq]


def test_order_queue_priority_then_fifo():
    q = _queue(Request, [(0, 0), (1, 1), (2, 0), (3, 1)])
    Scheduler().order_queue(q, {r.rid: i for i, r in enumerate(q)})
    assert [r.rid for r in q] == [1, 3, 0, 2]


@pytest.mark.parametrize("cap", [None, 1, 2, 3, 8])
def test_prefill_order_matches_reference(cap):
    prio = {0: 0, 1: 1, 2: 0, 3: 1, 4: 2}
    slots = [3, 0, 4, 1, 2]
    want = JScheduler(JSchedulerConfig(prefill_chunks_per_tick=cap)
                      ).prefill_order(slots, lambda i: prio[i])
    got = Scheduler(SchedulerConfig(prefill_chunks_per_tick=cap)
                    ).prefill_order(slots, lambda i: prio[i])
    assert got == want
    if cap == 2:
        assert got == [4, 1]


def test_prefill_chunks_per_tick_below_one_rejected():
    with pytest.raises(ValueError, match="prefill_chunks_per_tick=0"):
        SchedulerConfig(prefill_chunks_per_tick=0)
    with pytest.raises(ValueError, match="must be >= 1"):
        SchedulerConfig(prefill_chunks_per_tick=-3)
    assert SchedulerConfig(prefill_chunks_per_tick=1).prefill_chunks_per_tick \
        == 1
    assert SchedulerConfig().prefill_chunks_per_tick is None


def _pick(cands, below=None, cost=False, preempt=True):
    """(reference's pick, port's pick) as slots (None when no victim)."""
    jcm, tcm = _models() if cost else (None, None)
    jv = JScheduler(JSchedulerConfig(preempt=preempt), jcm).pick_victim(
        [JVictim(**c) for c in cands], below=below)
    tv = Scheduler(SchedulerConfig(preempt=preempt), tcm).pick_victim(
        [VictimInfo(**c) for c in cands], below=below)
    return (None if jv is None else jv.slot), (None if tv is None else tv.slot)


def _v(slot, priority, ctx, pages, swappable=False):
    return dict(slot=slot, rid=slot, priority=priority, ctx_tokens=ctx,
                pages=pages, swappable=swappable)


def test_pick_victim_ordering():
    a, b, c, d = (_v(0, 1, 4, 1), _v(1, 0, 90, 9), _v(2, 0, 10, 2),
                  _v(3, 0, 10, 5))
    assert _pick([a, b, c, d]) == (3, 3)
    assert _pick([a], below=1) == (None, None)
    assert _pick([a, b], below=1) == (1, 1)
    assert _pick([a, b], below=2) == (1, 1)
    assert _pick([a, b, c, d], preempt=False) == (None, None)


def test_pick_victim_uses_cost_model():
    short, long_ = _v(0, 0, 8, 1, True), _v(1, 0, 4096, 99, True)
    assert _pick([short, long_], cost=True) == (0, 0)


def test_pick_victim_mixed_swappable_prices_ring_as_recompute():
    ring, full = _v(0, 0, 1000, 4, False), _v(1, 0, 4096, 4, True)
    _, tcm = _models()
    assert tcm.swap_s(4096) < tcm.recompute_s(1000)
    assert _pick([ring, full], cost=True) == (1, 1)


victims = st.lists(
    st.tuples(st.integers(0, 2), st.integers(0, 5000), st.integers(0, 64),
              st.booleans()),
    min_size=0, max_size=8)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(victims, st.one_of(st.none(), st.integers(0, 3)), st.booleans(),
       st.booleans())
def test_pick_victim_drawn_sets_match_reference(rows, below, cost, preempt):
    cands = [_v(i, p, ctx, pages, sw)
             for i, (p, ctx, pages, sw) in enumerate(rows)]
    want, got = _pick(cands, below=below, cost=cost, preempt=preempt)
    assert got == want


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 20)),
                max_size=10, unique_by=lambda t: t[1]),
       st.lists(st.integers(0, 3), max_size=10),
       st.one_of(st.none(), st.integers(1, 4)))
def test_queue_and_prefill_order_drawn_match_reference(pairs, seats, cap):
    pairs = [(rid, p) for p, rid in pairs]
    arrival = {rid: s for (rid, _), s in zip(pairs, seats)}
    jq, tq = _queue(JRequest, pairs), _queue(Request, pairs)
    JScheduler().order_queue(jq, arrival)
    Scheduler().order_queue(tq, arrival)
    assert [r.rid for r in tq] == [r.rid for r in jq]
    prio = dict(pairs)
    slots = list(prio)
    assert (Scheduler(SchedulerConfig(prefill_chunks_per_tick=cap))
            .prefill_order(slots, prio.get)
            == JScheduler(JSchedulerConfig(prefill_chunks_per_tick=cap))
            .prefill_order(slots, prio.get))


# ---------------------------------------------------------------------------
# HostKVTier
# ---------------------------------------------------------------------------

def _fake_pages(n_pages=3, pad_to=4, dtype=torch.float32):
    """A small gathered tree: one remainder layer's pool and scale lane
    (pages on axis 0) and a pattern block's pool (a layer axis first),
    padded along the page axis as the engine's gather pads."""
    g = torch.Generator().manual_seed(0)
    return {
        "blocks": {"p0": {"k_pages": torch.randn(
            (2, pad_to, 8, 2, 4), generator=g).to(dtype)}},
        "rem": {"r0": {"k_pages": torch.randn((pad_to, 8, 2, 4),
                                              generator=g).to(dtype),
                       "k_scale": torch.randn((pad_to, 8), generator=g)}},
    }


def test_host_tier_roundtrip():
    tier = HostKVTier()
    entry = tier.put(7, _fake_pages(), n_pages=3, length=20)
    assert 7 in tier and len(tier) == 1
    assert tier.bytes_out == entry.nbytes == tier.bytes_held
    assert entry.nbytes == (2 * 4 * 64 + 4 * 64 + 4 * 8) * 4
    got, ok = tier.get(7)
    assert ok and got is entry and got.length == 20
    assert tier.bytes_in == entry.nbytes
    tier.pop(7)
    assert 7 not in tier and tier.bytes_held == 0
    tier.clear()
    assert tier.bytes_in == tier.bytes_out == 0


def test_host_tier_padding_pages_not_checksummed():
    tier = HostKVTier()
    entry = tier.put(1, _fake_pages(), n_pages=3, length=20)
    # a padding page (index 3 >= n_pages) changes: the null page does so
    # under masked decode writes
    entry.data["rem"]["r0"]["k_pages"][3] += 1.0
    entry.data["blocks"]["p0"]["k_pages"][:, 3] += 1.0
    _, ok = tier.get(1)
    assert ok


def test_host_tier_detects_corruption():
    tier = HostKVTier()
    entry = tier.put(1, _fake_pages(), n_pages=3, length=20)
    assert tier.corrupt(1)
    got, ok = tier.get(1)
    assert not ok and got is entry          # kept until popped
    assert tier.bytes_in == 0
    assert not tier.corrupt(99)


def test_corruption_lands_in_the_first_real_page_of_the_first_leaf():
    """``corrupt_entry`` flips byte 0 of the first leaf in the reference's
    flatten order (keys sorted at every level): page 0 of
    ``blocks/p0/k_pages`` here, inside the checksum's span."""
    data = _fake_pages()
    before = {p: t.clone() for p, t in tree_leaves(data)}
    entry = make_transfer_entry(0, data, n_pages=1, length=8)
    corrupt_entry(entry)
    changed = [p for p, t in tree_leaves(entry.data)
               if not torch.equal(t, before[p])]
    assert changed == [("blocks", "p0", "k_pages")]
    assert [p for p, _ in tree_leaves(data)] == [
        ("blocks", "p0", "k_pages"), ("rem", "r0", "k_pages"),
        ("rem", "r0", "k_scale")]
    assert checksum_pages(entry.data, 1) != entry.checksum


def test_host_tier_put_entry_installs_verbatim():
    entry = make_transfer_entry(3, _fake_pages(), n_pages=3, length=20)
    tier = HostKVTier()
    tier.put_entry(entry)
    assert 3 in tier and tier.bytes_out == entry.nbytes
    got, ok = tier.get(3)
    assert ok and got is entry
    damaged = make_transfer_entry(4, _fake_pages(), n_pages=3, length=20)
    corrupt_entry(damaged)
    tier.put_entry(damaged)
    _, ok = tier.get(4)
    assert not ok


def test_host_tier_bytes_in_skips_failed_entries():
    tier = HostKVTier()
    good = tier.put(1, _fake_pages(), n_pages=3, length=20)
    bad = tier.put(2, _fake_pages(), n_pages=3, length=20)
    assert tier.corrupt(2)
    _, ok = tier.get(2)
    assert not ok and tier.bytes_in == 0
    _, ok = tier.get(1)
    assert ok and tier.bytes_in == good.nbytes
    _, ok = tier.get(2)
    assert not ok and tier.bytes_in == good.nbytes
    assert tier.bytes_out == good.nbytes + bad.nbytes


def test_checksum_covers_exactly_real_pages():
    data = _fake_pages()
    c3 = checksum_pages(data, 3)
    data["rem"]["r0"]["k_pages"][2, 0, 0, 0] += 1.0       # inside the span
    assert checksum_pages(data, 3) != c3
    c2 = checksum_pages(data, 2)
    data["rem"]["r0"]["k_pages"][2, 0, 0, 0] += 1.0       # outside 2 pages
    assert checksum_pages(data, 2) == c2
    c2 = checksum_pages(data, 2)
    data["blocks"]["p0"]["k_pages"][1, 1, 0, 0, 0] += 1.0  # axis 1, page 1
    assert checksum_pages(data, 2) != c2


def test_checksum_of_a_bf16_pool_reads_raw_bytes():
    """numpy has no bfloat16: the checksum reads a bf16 pool's raw bytes,
    and a flip of one bit of one element moves it."""
    data = _fake_pages(dtype=torch.bfloat16)
    c = checksum_pages(data, 3)
    leaf = data["rem"]["r0"]["k_pages"]
    assert leaf.dtype == torch.bfloat16
    leaf.view(torch.int16)[1, 2, 1, 3] ^= 1
    assert checksum_pages(data, 3) != c
    tier = HostKVTier()
    tier.put(5, _fake_pages(dtype=torch.bfloat16), n_pages=3, length=20)
    assert tier.get(5)[1] and tier.corrupt(5) and not tier.get(5)[1]


def test_page_axis_by_name_and_rank():
    assert page_axis(("rem", "r0", "k_pages"), torch.zeros(4, 8, 2, 4)) == 0
    assert page_axis(("blocks", "p0", "v_pages"),
                     torch.zeros(2, 4, 8, 2, 4)) == 1
    assert page_axis(("rem", "r0", "v_scale"), torch.zeros(4, 8)) == 0
    assert page_axis(("blocks", "p0", "k_scale"), torch.zeros(2, 4, 8)) == 1
    with pytest.raises(ValueError, match="not a page-pool leaf"):
        page_axis(("rem", "r0", "kpos"), torch.zeros(4, 8))
    with pytest.raises(ValueError, match="unexpected rank"):
        page_axis(("x", "k_pages"), torch.zeros(3, 2, 4, 8, 2, 4))


# ---------------------------------------------------------------------------
# fault streams
# ---------------------------------------------------------------------------

def test_fault_kind_ids_are_the_references():
    assert T_KINDS == J_KINDS


@pytest.mark.parametrize("seed", [0, 5, 13, 2**31 - 1])
@pytest.mark.parametrize("kind", sorted(J_KINDS))
def test_fault_rng_streams_match_reference(seed, kind):
    j, t = j_fault_rng(seed, kind), fault_rng(seed, kind)
    np.testing.assert_array_equal(t.random(64), j.random(64))
    np.testing.assert_array_equal(t.integers(1, 9, size=32),
                                  j.integers(1, 9, size=32))
