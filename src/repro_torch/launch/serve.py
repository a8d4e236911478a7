"""Serving launcher: the continuous-batching engine over fresh weights
drawn from a seeded generator, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --requests 16 --batch 8 --max-len 1024 --max-new 32

``--cache`` picks the KV backend (``auto`` lets the engine pick: paged);
``--kv-int8`` stores the KV cache as int8 with a float32 scale per token;
prefill attention is the reference launcher's, ``chunked`` with 64-token
blocks, and so is its MoE dispatch, ``dense``.  ``--arch gemma2-27b``
serves its sliding-window layers from ring pages; ``recurrentgemma-9b``
and ``mamba2-130m`` keep their recurrent state beside the pools
(mamba2-130m, with no attention layer, has none); the MoE stacks
(granite-moe-3b-a800m, grok-1-314b) serve from pages, pixtral-12b's text
prompts from the dense cache.  seamless-m4t-medium fails at its first
prefill, as the reference's launcher does: the requests carry no encoder
frames.  ``--smoke`` serves the same architecture at smoke width;
``--device cpu`` runs the plain PyTorch path on the CPU (without it, a
host with no card is an error).  ``--priority`` gives the requests
scheduler classes (``mixed``: odd rids high), which admit high first and
let a high request preempt a low one when slots or pages run out.

``--topology disagg`` serves through a
:class:`~repro_torch.serve.cluster.DisaggPool`: ``--prefill-replicas``
engines prefill and ship each finished prompt's pages to ``--dp`` decode
engines, all on the one device and sharing one weight tree;
``--link-bw`` prices the shipment against a decode-side prefill and
``--route`` pins the decision.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --topology disagg --dp 1 --requests 16 --batch 8 --max-len 1024

``--tp`` shards each engine over a device group (one
:class:`~repro_torch.dist.serve.ServeMesh`), and ``--dp`` runs that many
engine replicas, each on its own group, behind one admission queue
(:class:`ReplicaPool`: the least-loaded replica takes each request).  The
groups come from the visible cards, each card used once, so ``--tp 2
--dp 2`` needs four; fewer distinct devices than ``tp x dp`` is an error.
``--devices`` names the devices explicitly and may repeat one (two shards
on one card, or ``cpu,cpu`` on the CPU):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --smoke --tp 2 --devices cpu,cpu --requests 6 --batch 2

TP shards a single engine's params and KV page pools across a mesh axis;
DP adds whole engines that share no device state, so the DP axis is pure
scheduling: in the paper's framing TP adds memory channels behind one
request stream while DP adds whole ports, and the admission queue is the
host-side arbiter between them.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.dist import ServeMesh
from repro_torch.launch.mesh import visible_devices
from repro_torch.models import RuntimeFlags, build
from repro_torch.serve import (DisaggConfig, DisaggPool, Request,
                               ServeEngine, ServeStats, aggregate_stats)

# request i's scheduler class under each --priority mix (the reference
# launcher's)
_PRIORITY_MIX = {"off": lambda i: 0, "low": lambda i: 0,
                 "high": lambda i: 1, "mixed": lambda i: i % 2}



def device_groups(tp: int, dp: int,
                  devices: Optional[Sequence] = None) -> List[list]:
    """Split ``devices`` (default: the visible cards) into ``dp`` disjoint
    TP groups of ``tp`` devices each (replica ``i`` owns
    ``devices[i*tp:(i+1)*tp]``)."""
    devs = list(visible_devices() if devices is None else devices)
    if tp < 1 or dp < 1:
        raise ValueError(f"tp={tp} and dp={dp} must be >= 1")
    if tp * dp > len(devs):
        raise ValueError(
            f"tp={tp} x dp={dp} needs {tp * dp} devices, have {len(devs)}")
    return [devs[i * tp:(i + 1) * tp] for i in range(dp)]


class ReplicaPool:
    """A shared admission queue over independent engine replicas (the DP
    axis).  ``submit`` routes each request to the least-loaded replica
    (queued + in-flight requests; ties go to the lowest index, so an idle
    pool round-robins).  Replicas never share device state: the pool is
    scheduling only."""

    def __init__(self, engines: Sequence[ServeEngine]):
        if not engines:
            raise ValueError("ReplicaPool needs at least one engine")
        self.engines = list(engines)
        self.routed = [0] * len(self.engines)   # per-replica request counts

    @staticmethod
    def _load(eng: ServeEngine) -> int:
        return len(eng.queue) + sum(s is not None for s in eng.slots)

    def submit(self, req: Request) -> int:
        """Admit ``req`` to the least-loaded replica; returns its index."""
        i = min(range(len(self.engines)),
                key=lambda j: self._load(self.engines[j]))
        self.engines[i].add_request(req)
        self.routed[i] += 1
        return i

    def drain(self, max_rounds: int = 100_000) -> ServeStats:
        """Step every replica that still has work until all are idle; the
        budget counts rounds (one step of every busy replica)."""
        for _ in range(max_rounds):
            busy = [e for e in self.engines
                    if e.queue or any(s is not None for s in e.slots)]
            if not busy:
                return self.stats()
            for eng in busy:
                eng.step()
        busy = [e for e in self.engines
                if e.queue or any(s is not None for s in e.slots)]
        agg = self.stats()
        raise RuntimeError(
            f"replica pool failed to drain in {max_rounds} rounds: "
            f"{len(busy)}/{len(self.engines)} replicas busy, "
            f"{sum(len(e.queue) for e in self.engines)} queued; partial "
            f"aggregate: tokens_out={agg.tokens_out}, "
            f"prefills={agg.prefills}, decode_steps={agg.decode_steps}, "
            f"pool_stalls={agg.pool_stalls}")

    def stats(self) -> ServeStats:
        """Every ServeStats field summed across replicas (peaks sum too:
        the pool's total live-page commitment)."""
        return aggregate_stats(self.engines)


def build_pool(bundle, params, *, tp: int = 1, dp: int = 1,
               devices: Optional[Sequence] = None,
               **engine_kw) -> ReplicaPool:
    """``dp`` engine replicas, each TP-sharded over its own ``tp``-device
    group of ``devices`` (default: the visible cards).  With ``tp * dp ==
    1`` the single engine runs undistributed (no mesh, any backend); any
    wider layout places page pools by mesh, so the paged backend is
    required.  Replicas on one device share the ``params`` tree."""
    if tp * dp == 1:
        return ReplicaPool([ServeEngine(bundle, params, **engine_kw)])
    engine_kw.setdefault("cache_backend", "paged")
    engine_kw.pop("device", None)        # each replica's is its group's
    groups = device_groups(tp, dp, devices)
    return ReplicaPool([ServeEngine(bundle, params, **engine_kw,
                                    dist=ServeMesh.tp(tp, devices=g))
                        for g in groups])


def build_disagg_pool(bundle, params, *, tp: int = 1,
                      prefill_replicas: int = 1, decode_replicas: int = 1,
                      devices: Optional[Sequence] = None,
                      disagg_config: Optional[DisaggConfig] = None,
                      **engine_kw) -> DisaggPool:
    """The ``disagg`` topology: a prefill pool that ships every finished
    prompt's pages to a decode pool as a checksummed transfer entry
    (:class:`~repro_torch.serve.cluster.DisaggPool`), paged engines with
    the host swap tier on both sides.  Disaggregation is a scheduling
    topology, so the pools may share devices: with ``tp == 1`` every
    engine runs undistributed on the bundle's device and serves the one
    ``params`` tree; with ``tp > 1`` each engine gets its own disjoint
    ``tp``-device group of ``devices`` (default: the visible cards) when
    there are enough, prefill groups first, and otherwise every engine
    shards over the same first ``tp`` devices (the hand-off is still a
    per-shard gather and scatter between meshes)."""
    if prefill_replicas < 1 or decode_replicas < 1:
        raise ValueError("disagg topology needs >= 1 prefill and >= 1 "
                         "decode replica")
    engine_kw.setdefault("cache_backend", "paged")
    n = prefill_replicas + decode_replicas
    if tp == 1:
        engines = [ServeEngine(bundle, params, **engine_kw)
                   for _ in range(n)]
    else:
        engine_kw.pop("device", None)
        pool = list(visible_devices() if devices is None else devices)
        if len(pool) >= tp * n:
            groups = device_groups(tp, n, pool)
        else:
            if len(pool) < tp:
                raise ValueError(f"tp={tp} needs {tp} devices, have "
                                 f"{len(pool)}")
            groups = [pool[:tp]] * n
        engines = [ServeEngine(bundle, params, **engine_kw,
                               dist=ServeMesh.tp(tp, devices=g))
                   for g in groups]
    return DisaggPool(engines[:prefill_replicas],
                      engines[prefill_replicas:], config=disagg_config)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--window", type=int, default=8,
                    help="decode ticks per host sync")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache with per-token float32 scales")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights + traffic seed")
    ap.add_argument("--priority", default="off",
                    choices=sorted(_PRIORITY_MIX),
                    help="scheduler priority classes for the request mix")
    ap.add_argument("--cache", default="auto",
                    choices=("auto", "dense", "paged"),
                    help="KV backend; auto lets the engine pick")
    ap.add_argument("--device", default=None,
                    help="default: cuda (a host without a card is an error)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width per engine replica")
    ap.add_argument("--dp", type=int, default=1,
                    help="independent engine replicas (device groups); "
                         "decode replicas under --topology disagg")
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices the tp x dp groups take, "
                         "in order; may repeat one (default: the visible "
                         "cards, or --device alone)")
    ap.add_argument("--topology", default="colocated",
                    choices=("colocated", "disagg"),
                    help="colocated: one engine prefills and decodes.  "
                         "disagg: a prefill pool ships finished prompts' "
                         "pages to a decode pool (DisaggPool); --dp counts "
                         "decode replicas")
    ap.add_argument("--prefill-replicas", type=int, default=1,
                    help="prefill-pool replicas under --topology disagg")
    ap.add_argument("--link-bw", type=float, default=32e9,
                    help="prefill->decode transfer link bandwidth (prices "
                         "the disagg-vs-colocated routing break-even)")
    ap.add_argument("--route", default="auto",
                    choices=("auto", "disagg", "colocated"),
                    help="pin the disagg router's per-request decision "
                         "(auto defers to the swap cost model)")
    args = ap.parse_args(argv)

    cfg = smoke_config(ARCHS[args.arch]) if args.smoke else ARCHS[args.arch]
    flags = RuntimeFlags(attn_impl="chunked", attn_bq=64, attn_bkv=64,
                         moe_impl="dense",
                         kv_dtype="int8" if args.kv_int8 else "native")
    devices = (args.devices.split(",") if args.devices
               else [args.device] if args.device else None)
    home = args.device or (devices[0] if devices else None)
    bundle = build(cfg, flags, device=home)
    gen = torch.Generator(device=bundle.device).manual_seed(args.seed)
    params = bundle.init(gen)
    engine_kw = dict(batch_size=args.batch, max_len=args.max_len,
                     window=args.window, seed=args.seed, device=home)
    if args.cache != "auto":
        engine_kw["cache_backend"] = args.cache
    colocated_pool = args.topology == "colocated" and args.tp * args.dp > 1
    try:
        if args.topology == "disagg":
            pool = build_disagg_pool(
                bundle, params, tp=args.tp,
                prefill_replicas=args.prefill_replicas,
                decode_replicas=args.dp, devices=devices,
                disagg_config=DisaggConfig(
                    link_bw=args.link_bw,
                    force=None if args.route == "auto" else args.route),
                **engine_kw)
            submit = pool.submit
        elif colocated_pool:
            pool = build_pool(bundle, params, tp=args.tp, dp=args.dp,
                              devices=devices, **engine_kw)
            submit = pool.submit
        else:
            eng = ServeEngine(bundle, params, **engine_kw)
            submit = eng.add_request
    except ValueError as e:
        raise SystemExit(f"error: {e}") from e
    rng = np.random.default_rng(args.seed)
    mix = _PRIORITY_MIX[args.priority]
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=int(rng.integers(4, 24))).astype(np.int32)
        submit(Request(rid=i, prompt=prompt, max_new_tokens=args.max_new,
                       priority=mix(i)))
    t0 = time.perf_counter()
    if args.topology == "disagg" or colocated_pool:
        stats = pool.run() if args.topology == "disagg" else pool.drain()
        for e in pool.engines:
            if e.device.type == "cuda":
                torch.cuda.synchronize(e.device)
        dt = time.perf_counter() - t0
        print(f"{stats.tokens_out} tokens in {dt:.2f}s "
              f"({stats.tokens_out / dt:.1f} tok/s) across "
              f"{len(pool.engines)} replica(s) x tp={args.tp}, "
              f"prefills={stats.prefills}, decode_steps={stats.decode_steps}, "
              f"decode_dispatches={stats.decode_dispatches}")
        if colocated_pool:
            print("per-replica requests: "
                  + ", ".join(f"r{i}={n}" for i, n in enumerate(pool.routed)))
            return 0
        d = pool.dstats
        print(f"disagg: {d.disagg_routed} shipped / {d.colocated_routed} "
              f"colocated, {d.transfers} transfers "
              f"({stats.transfer_bytes} bytes), "
              f"{stats.transfer_fallbacks} recompute fallbacks, "
              f"{d.rounds} rounds")
        return 0
    stats = eng.run_to_completion()
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(bundle.device)
             if bundle.device.type == "cuda" else str(bundle.device))
    print(f"{cfg.name}{' (smoke)' if args.smoke else ''} on {where}, "
          f"{eng.backend} cache{' (int8)' if args.kv_int8 else ''}: "
          f"{stats.tokens_out} tokens in {dt:.2f}s "
          f"({stats.tokens_out / dt:.1f} tok/s), prefills={stats.prefills}, "
          f"prefill_retraces={stats.prefill_retraces}, "
          f"prefill_chunks={stats.prefill_chunks}, "
          f"decode_steps={stats.decode_steps}, "
          f"decode_dispatches={stats.decode_dispatches}, "
          f"prefix_hit_tokens={stats.prefix_hit_tokens}, "
          f"pages_peak={stats.pages_peak}, "
          f"ring_pages_peak={stats.ring_pages_peak}, "
          f"priority={args.priority}, preemptions={stats.preemptions}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
