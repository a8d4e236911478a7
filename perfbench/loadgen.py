"""Traffic for a cell, read from ``perfbench/traffic/<name>.json``.

The arithmetic follows the port's cluster traffic (Poisson arrivals whose
rate a two-state calm/burst phase modulates, prompts opening with one of
a few shared prefixes drawn Zipf), rewritten on a clock of seconds and at
deployment lengths.

Two seeds drive it.  ``shape_seed``, fixed in the traffic file, draws what
sets the amount of work: the arrival times, and the pairing of prompt and
output lengths inside a block.  The run's ``--seed`` draws only the order
of the requests inside each block and every token's content.  So every
seed serves the same multiset of sizes at the same times, in another
order: a run-to-run spread measures the system, not the draw.

Lengths are stratified: a block of ``block`` requests holds the
``(j + 0.5) / block`` quantiles of each length distribution, paired by a
fixed permutation.  Length distributions are log-uniform over ``[lo,
hi]``; the shared prefix (if any) is drawn Zipf over ``count`` prefixes,
also by stratified quantiles.

A closed loop starts in steady state: client ``i``'s first request is
already ``age`` tokens into its answer (its prompt carries those tokens,
its budget is what is left).  Output lengths of a request in progress at a
random instant are length-biased, which for a log-uniform law is uniform
over ``[lo, hi]``, and its age is uniform over its length; both are taken
at stratified quantiles too.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

LOOPS = ("closed", "open")


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def loguniform_at(u: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Log-uniform lengths over [lo, hi] at quantiles ``u``."""
    return np.floor(lo * (hi / lo) ** u + 0.5).astype(np.int64).clip(lo, hi)


def zipf_at(u: np.ndarray, count: int, a: float) -> np.ndarray:
    """Zipf(a) indices over ``count`` items at quantiles ``u``."""
    w = 1.0 / np.arange(1, count + 1) ** a
    cdf = np.cumsum(w / w.sum())
    return np.searchsorted(cdf, u, side="right").clip(0, count - 1)


def mmpp_arrivals(rng: np.random.Generator, rate: float, horizon: float,
                  burst_mult: float = 1.0, burst_mean_s: float = 1.0,
                  calm_mean_s: float = 1.0) -> np.ndarray:
    """Arrival times in [0, horizon) of a Poisson process whose rate a
    two-state Markov phase modulates: calm at ``r``, bursts at
    ``burst_mult * r``, phases exponential with the given means.  ``rate``
    is the long-run mean: ``r`` is set so the phases average to it."""
    share = burst_mean_s / (burst_mean_s + calm_mean_s)
    calm = rate / (1.0 - share + share * burst_mult)
    out = []
    t, burst = 0.0, False
    phase_left = rng.exponential(calm_mean_s)
    while t < horizon:
        # unit-rate work to the next arrival, spent at each phase's rate
        work = rng.exponential(1.0)
        while True:
            r = calm * (burst_mult if burst else 1.0)
            if work <= r * phase_left:
                t += work / r
                phase_left -= work / r
                break
            work -= r * phase_left
            t += phase_left
            burst = not burst
            phase_left = rng.exponential(burst_mean_s if burst
                                         else calm_mean_s)
        if t < horizon:
            out.append(t)
    return np.asarray(out)


@dataclass
class Spec:
    """A traffic file, checked."""
    name: str
    loop: str
    prompt: Tuple[int, int]
    output: Tuple[int, int]
    engine: dict
    block: int
    shape_seed: int
    clients: int = 0
    rate: float = 0.0
    burst: Optional[dict] = None
    prefix: Optional[dict] = None
    ramp_s: float = 0.0
    drain_s: float = 60.0
    profile_seconds: float = 3.0

    @classmethod
    def from_dict(cls, d: dict) -> "Spec":
        loop = d["loop"]
        if loop not in LOOPS:
            raise ValueError(f"traffic {d.get('name')}: loop {loop!r} is "
                             f"not one of {LOOPS}")
        s = cls(name=d["name"], loop=loop,
                prompt=(int(d["prompt"]["lo"]), int(d["prompt"]["hi"])),
                output=(int(d["output"]["lo"]), int(d["output"]["hi"])),
                engine=dict(d["engine"]), block=int(d["block"]),
                shape_seed=int(d["shape_seed"]),
                clients=int(d.get("clients", 0)),
                rate=float(d.get("rate", 0.0)), burst=d.get("burst"),
                prefix=d.get("prefix"), ramp_s=float(d.get("ramp_s", 0.0)),
                drain_s=float(d.get("drain_s", 60.0)),
                profile_seconds=float(d.get("profile_seconds", 3.0)))
        longest = (s.prefix_tokens + s.prompt[1] + s.output[1])
        if longest > s.engine["max_len"]:
            raise ValueError(f"traffic {s.name}: the longest request "
                             f"({longest} tokens) exceeds max_len "
                             f"{s.engine['max_len']}")
        if loop == "closed" and s.clients > s.engine["batch"]:
            raise ValueError(f"traffic {s.name}: {s.clients} clients over "
                             f"a batch of {s.engine['batch']}")
        if loop == "open" and s.rate <= 0:
            raise ValueError(f"traffic {s.name}: an open loop needs a rate")
        return s

    @property
    def prefix_tokens(self) -> int:
        return int(self.prefix["tokens"]) if self.prefix else 0


class Traffic:
    """The request stream of one run: ``request(k)`` is the k-th request
    the clients send, ``initial(i)`` a closed loop's first request of
    client ``i``, ``arrivals(horizon)`` an open loop's schedule.  Prompts
    are int32 arrays, budgets counts of output tokens."""

    def __init__(self, spec: Spec, seed: int, vocab: int):
        self.spec = spec
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        shape = np.random.default_rng(spec.shape_seed)
        m = spec.block
        self.tmpl_prompt = loguniform_at(_quantiles(m), *spec.prompt)
        self.tmpl_out = loguniform_at(_quantiles(m)[shape.permutation(m)],
                                      *spec.output)
        self.tmpl_prefix = (zipf_at(_quantiles(m)[shape.permutation(m)],
                                    int(spec.prefix["count"]),
                                    float(spec.prefix.get("zipf", 1.0)))
                            if spec.prefix else np.full(m, -1))
        self.prefixes = ([self._tokens(spec.prefix_tokens)
                          for _ in range(int(spec.prefix["count"]))]
                         if spec.prefix else [])
        self._order: List[np.ndarray] = []

    def _tokens(self, n: int) -> np.ndarray:
        return self.rng.integers(0, self.vocab, size=int(n)).astype(np.int32)

    def shape(self, k: int) -> Tuple[int, int, int]:
        """(prefix index or -1, unique prompt tokens, output tokens) of the
        k-th request: block ``k // block`` in this run's order."""
        m = self.spec.block
        while len(self._order) <= k // m:
            self._order.append(self.rng.permutation(m))
        j = int(self._order[k // m][k % m])
        return (int(self.tmpl_prefix[j]), int(self.tmpl_prompt[j]),
                int(self.tmpl_out[j]))

    def request(self, k: int) -> Tuple[np.ndarray, int]:
        pidx, n, out = self.shape(k)
        body = self._tokens(n)
        if pidx >= 0:
            body = np.concatenate([self.prefixes[pidx], body])
        return body, out

    def initial(self, i: int) -> Tuple[np.ndarray, int]:
        """Client ``i``'s first request in a closed loop, started in steady
        state: length-biased output, a stratified age into it."""
        c = self.spec.clients
        shape = np.random.default_rng(self.spec.shape_seed + 1)
        u_len, u_age, u_prompt = (_quantiles(c)[shape.permutation(c)]
                                  for _ in range(3))
        lo, hi = self.spec.output
        total = int(math.floor(lo + (hi - lo) * u_len[i]))
        age = int(math.floor(u_age[i] * total))
        prompt = int(loguniform_at(u_prompt[i:i + 1], *self.spec.prompt)[0])
        return self._tokens(prompt + age), max(1, total - age)

    def arrivals(self, horizon: float, rate: Optional[float] = None
                 ) -> np.ndarray:
        """An open loop's arrival times (seconds from the ramp's start)."""
        b = self.spec.burst or {}
        shape = np.random.default_rng(self.spec.shape_seed + 2)
        return mmpp_arrivals(shape, rate or self.spec.rate, horizon,
                             float(b.get("mult", 1.0)),
                             float(b.get("mean_s", 1.0)),
                             float(b.get("calm_mean_s", 1.0)))
