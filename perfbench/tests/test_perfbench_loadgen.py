"""The load generator: one seed gives one schedule; another seed the same
sizes at the same times in another order, with other tokens; lengths stay
in their ranges and the arrival rate is the stated one."""
import numpy as np
import pytest

from perfbench import registry
from perfbench.loadgen import Spec, Traffic, loguniform_at, mmpp_arrivals

MIXES = ["reason-batch", "longdoc-batch", "chat-online"]


def spec(name):
    return Spec.from_dict(registry.traffic_file(name))


def stream(s, seed, n):
    t = Traffic(s, seed, 1000)
    return [t.request(k) for k in range(n)]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_schedule(mix):
    s = spec(mix)
    a, b = stream(s, 2 ** 31 + 12345, 70), stream(s, 2 ** 31 + 12345, 70)
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1]
               for x, y in zip(a, b))
    if s.loop == "open":
        ta = Traffic(s, 1, 1000).arrivals(60.0)
        tb = Traffic(s, 2, 1000).arrivals(60.0)
        assert np.array_equal(ta, tb)     # times are the shape's, not the seed's


@pytest.mark.parametrize("mix", MIXES)
def test_other_seed_same_sizes_other_order(mix):
    s = spec(mix)
    n = s.block * 2
    a, b = stream(s, 1, n), stream(s, 2, n)
    la = sorted((len(p), o) for p, o in a)
    lb = sorted((len(p), o) for p, o in b)
    assert la == lb
    assert [len(p) for p, _ in a] != [len(p) for p, _ in b]
    assert not np.array_equal(a[0][0][:8], b[0][0][:8])


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_in_range(mix):
    s = spec(mix)
    t = Traffic(s, 7, 1000)
    for k in range(3 * s.block):
        pidx, n, out = t.shape(k)
        assert s.prompt[0] <= n <= s.prompt[1]
        assert s.output[0] <= out <= s.output[1]
        assert (pidx >= 0) == bool(s.prefix)
    if s.loop == "closed":
        for i in range(s.clients):
            p, out = t.initial(i)
            assert out >= 1
            assert len(p) + out <= s.engine["max_len"]
            assert len(p) >= s.prompt[0]


def test_loguniform_quantiles():
    u = (np.arange(1000) + 0.5) / 1000
    x = loguniform_at(u, 128, 1024)
    assert x.min() >= 128 and x.max() <= 1024
    # the log-uniform mean (hi - lo) / ln(hi / lo)
    assert abs(x.mean() - (1024 - 128) / np.log(8)) < 3


def test_prefix_zipf_skew():
    s = spec("chat-online")
    t = Traffic(s, 3, 1000)
    counts = np.bincount([t.shape(k)[0] for k in range(s.block)],
                         minlength=s.prefix["count"])
    assert counts[0] == counts.max() and counts[0] > counts[-1]


def test_arrival_rate_and_bursts():
    rng = np.random.default_rng(0)
    t = mmpp_arrivals(rng, 5.0, 20000.0, 3.0, 2.0, 8.0)
    assert abs(len(t) / 20000.0 - 5.0) < 0.15
    gaps = np.diff(t)
    # bursts make the gaps more variable than a Poisson process's (cv 1)
    assert gaps.std() / gaps.mean() > 1.02
