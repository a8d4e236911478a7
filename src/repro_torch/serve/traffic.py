"""Open-loop traffic for the cluster front end (the port of
``repro.serve.traffic``): heavy traffic from many users, shrunk onto a
virtual clock so every draw is reproducible.

``generate_traffic`` emits an arrival schedule, ``(round, Request)``
pairs, with the three properties that stress a router:

- **Poisson and bursty arrivals**: exponential gaps whose rate a
  two-state (calm/burst) Markov phase modulates, so the schedule has
  steady load and the bursts that blow queue-delay predictions;
- **Zipf-shared prefixes**: each prompt opens with one of ``n_prefixes``
  common prefixes drawn Zipf(``zipf_a``), the skew that makes
  cache-aware routing beat least-loaded;
- **mixed lengths and SLOs**: uniform prompt-tail and output lengths, an
  optional deadline window (rounds after arrival) and a high-priority
  share.

Everything comes from one seeded ``numpy`` generator, drawn in the
reference's order, so a config gives the reference's schedule: arrival
rounds, rids, prompts, budgets, priorities and deadlines.  Each call
returns fresh :class:`Request` objects (serving mutates them).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.engine import Request
from repro_torch.serve.scheduler import PRIORITY_HIGH, PRIORITY_LOW


@dataclass(frozen=True)
class TrafficConfig:
    seed: int = 0
    n_requests: int = 32
    rate: float = 1.0              # mean arrivals per round (calm phase)
    burst_rate_mult: float = 1.0   # rate multiplier inside a burst (1 = off)
    phase_rounds: float = 8.0      # mean rounds per calm/burst phase
    # -- prompt shape ----------------------------------------------------
    n_prefixes: int = 4            # shared-prefix vocabulary
    zipf_a: float = 1.2            # Zipf exponent over the prefixes
    prefix_len: int = 16           # tokens per shared prefix
    tail_lo: int = 3               # unique prompt tail, uniform [lo, hi]
    tail_hi: int = 9
    # -- output / SLO ----------------------------------------------------
    out_lo: int = 4                # max_new_tokens, uniform [lo, hi]
    out_hi: int = 12
    deadline_rounds: Optional[Tuple[int, int]] = None  # uniform window
    high_priority_frac: float = 0.0


def generate_traffic(cfg: TrafficConfig,
                     vocab_size: int) -> List[Tuple[int, Request]]:
    """The arrival schedule, sorted by round (rids follow arrival order).
    A pure function of ``(cfg, vocab_size)``."""
    rng = np.random.default_rng(cfg.seed)
    prefixes = [rng.integers(0, vocab_size, size=cfg.prefix_len)
                .astype(np.int32) for _ in range(cfg.n_prefixes)]
    weights = 1.0 / np.arange(1, cfg.n_prefixes + 1) ** cfg.zipf_a
    weights /= weights.sum()

    schedule: List[Tuple[int, Request]] = []
    t = 0.0
    burst = False
    phase_left = rng.exponential(cfg.phase_rounds)
    for rid in range(cfg.n_requests):
        rate = cfg.rate * (cfg.burst_rate_mult if burst else 1.0)
        gap = rng.exponential(1.0 / max(rate, 1e-9))
        t += gap
        phase_left -= gap
        while phase_left <= 0:
            burst = not burst
            phase_left += rng.exponential(cfg.phase_rounds)
        arrival = int(t)
        pidx = int(rng.choice(cfg.n_prefixes, p=weights))
        tail = rng.integers(0, vocab_size,
                            size=int(rng.integers(cfg.tail_lo,
                                                  cfg.tail_hi + 1))
                            ).astype(np.int32)
        prompt = np.concatenate([prefixes[pidx], tail])
        deadline = None
        if cfg.deadline_rounds is not None:
            lo, hi = cfg.deadline_rounds
            deadline = arrival + int(rng.integers(lo, hi + 1))
        prio = (PRIORITY_HIGH if rng.random() < cfg.high_priority_frac
                else PRIORITY_LOW)
        schedule.append((arrival, Request(
            rid=rid, prompt=prompt,
            max_new_tokens=int(rng.integers(cfg.out_lo, cfg.out_hi + 1)),
            priority=prio, deadline=deadline)))
    return schedule
