"""The trace reduction and the per-layer readers on records made by hand:
the union of device intervals, idle gaps labelled by the host span open
at their start, kernel time matched by name, and each reader's arithmetic
(or its silence where it finds nothing to read)."""
import pytest

from perfbench import flops, registry, trace
from perfbench.peaks import H100

DIMS = dict(num_layers=2, d_model=8, num_heads=4, num_kv_heads=2,
            head_dim=2, d_ff=16, vocab_size=10, num_experts=0,
            num_experts_per_tok=0)


def test_union_and_gaps():
    assert trace.union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert trace.gaps([(0, 3), (5, 6)], 0, 10) == [(3, 5), (6, 10)]


def test_reduce():
    ops = [("k_paged_attention", 10.0, 30.0), ("gemm", 25.0, 50.0),
           ("gemm", 80.0, 90.0), ("outside", 200.0, 300.0)]
    host = [(trace.SLICE, 0.0, 100.0),
            ("perfbench.decode_window", 5.0, 60.0),
            ("perfbench.prefill_chunk", 70.0, 95.0)]
    r = trace.reduce(ops, host, {"k1": "paged_attention"})
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(50e-6)      # 10..50 and 80..90
    assert r["matched_s"]["k1"] == pytest.approx(20e-6)
    assert r["device_ops"][0] == ["gemm", pytest.approx(35e-6)]
    got = [(n, round(s * 1e6)) for n, s in r["idle_gaps"]]
    assert got[0] == ("perfbench.decode_window", 30)
    assert sorted(got[1:]) == [("host between calls", 10),
                               ("perfbench.prefill_chunk", 10)]


def records(ticks, chunks, k1_s, window_s=1.0, busy_s=0.25):
    return dict(dims=DIMS, kv_itemsize=2, live_kv_bytes_peak=3 * 2 ** 30,
                window_stats=dict(prompt_tokens=200, prefix_hit_tokens=50),
                decode_windows=[(0.08, 4), (0.04, 2)],
                prefill_chunks=[0.1, 0.3],
                slice=dict(n_device_ops=10, window_s=window_s,
                           busy_s=busy_s, matched_s={"paged_attention": k1_s},
                           ticks=ticks, chunks=chunks,
                           stats=dict(tokens_out=34, prefills=2,
                                      decode_steps=4)))


def read(name, r):
    return registry.metric_reader(name)(r)


def test_readers():
    ticks, chunks = [[3, 5], [4, 6]], [(0, 8)]
    r = records(ticks, chunks, k1_s=1e-6)
    assert read("engine.active_slots.batch", r) == 8.0
    assert read("engine.prefix_hit_share.online", r) == 25.0
    assert read("kvcache.live_gib_peak.batch", r) == 3.0
    assert read("model.tick_ms.batch", r) == pytest.approx(20.0)
    assert read("model.prefill_chunk_ms.online", r) == pytest.approx(200.0)
    assert read("device.idle_share.batch", r) == pytest.approx(75.0)
    work = (flops.decode_tick_flops(DIMS, [3, 5])
            + flops.decode_tick_flops(DIMS, [4, 6])
            + flops.prefill_chunk_flops(DIMS, 0, 8))
    assert read("mfu.batch", r) == pytest.approx(
        100 * work / H100["bf16_flops"])
    b, f = flops.k1_ticks(DIMS, ticks, 2)
    assert read("paged_attention_roofline", r) == pytest.approx(
        100 * max(b / H100["hbm_bytes_per_s"], f / H100["bf16_flops"])
        / 1e-6)


def test_readers_silent_without_a_device_trace():
    r = records([[3]], [], k1_s=0.0)
    r["slice"]["n_device_ops"] = 0
    for name in ("mfu.batch", "paged_attention_roofline",
                 "device.idle_share.batch", "device.idle_share.online"):
        assert read(name, r) is None
    r["decode_windows"], r["prefill_chunks"] = [], []
    assert read("model.tick_ms.batch", r) is None
    assert read("model.prefill_chunk_ms.batch", r) is None
