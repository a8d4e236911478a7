"""One run of one cell: set-up, the measured window, the output check.

Set-up draws the weights on the device from the seed, builds the engine
as the port's serving launcher does (``repro_torch.models.build`` with the
configuration's runtime flags, then ``ServeEngine``), warms each prefill
bucket the traffic can reach, and runs the traffic until the engine is in
steady state (a closed loop: every client's first request prefilled; an
open loop: ``ramp_s`` seconds of the schedule).  The window then drives
the engine through its public calls (``add_request``,
``run_to_completion(max_ticks=window)``, which admits, prefills one chunk
a pending slot and runs one decode window) for ``seconds``.  Token times
are the host clock when the call that produced them returns; that call
ends in the engine's own host read of the tokens.

The traced run (``trace=True``) is the same run with every prefill chunk
and decode window wrapped in a span that synchronises the device before
and after (so it is never used for the end-to-end metrics), and a
``torch.profiler`` slice of ``profile_seconds`` inside the window.

After the window (and, in an open loop, after every request due in it has
finished or a minute has passed), the device memory peak is read, the
engine is freed, and a sample of finished requests is run through the
plain float32 reference (:mod:`perfbench.reference`): the gaps by which
the served tokens' logits lie below the reference's best, the widest or
the mean as ``checks/<cell>.json`` names it, are held to the cell's
limits there.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import resource
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import flops, trace, weights
from perfbench.loadgen import Spec, Traffic
from perfbench.reference import common as ref

K1 = "paged_attention"          # the K1 kernel's entry name, as launched
MODEL_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "num_experts",
              "num_experts_per_tok", "rope_theta", "tie_embeddings")


@dataclass
class Info:
    """What the harness knows of one request."""
    req: object
    arrival: float                 # scheduled (open loop) or sent
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    sent: float = 0.0


@dataclass
class Span:
    name: str
    t0: float
    t1: float = 0.0
    in_slice: bool = False
    offset: int = 0
    length: int = 0
    ticks: int = 0
    contexts: List[List[int]] = field(default_factory=list)


class Recorder:
    """Spans of the traced run, each closed by a device synchronise."""

    def __init__(self, device: torch.device):
        self.device = device
        self.spans: List[Span] = []
        self.in_slice = False

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str, **kw):
        self._sync()
        sp = Span(name, time.perf_counter(), in_slice=self.in_slice, **kw)
        with torch.profiler.record_function(f"perfbench.{name}"):
            yield sp
            self._sync()
        sp.t1 = time.perf_counter()
        self.spans.append(sp)


def traced_engine(ServeEngine, rec: Recorder):
    """The engine with a synchronised span around each prefill chunk and
    each decode window; a window's span keeps the context each active slot
    attended over at each tick (prompt plus tokens so far)."""

    class TracedEngine(ServeEngine):
        def _prefill_tick(self, slot):
            req = self.slots[slot]
            off = self._pending[slot]
            c = min(self.prefill_chunk, len(req.prompt) - off)
            with rec.span("prefill_chunk", offset=off, length=c):
                super()._prefill_tick(slot)

        def decode_many(self, n):
            before = [(r, len(r.out_tokens)) for r in self.slots
                      if r is not None]
            steps = self.stats.decode_steps
            with rec.span("decode_window") as sp:
                out = super().decode_many(n)
            sp.ticks = self.stats.decode_steps - steps
            adv = [(len(r.prompt) + k0, len(r.out_tokens) - k0)
                   for r, k0 in before]
            sp.contexts = [[p + t for p, a in adv if a > t]
                           for t in range(sp.ticks)]
            return out

    return TracedEngine


def check_model(cfg, dims: dict, dtypes: dict) -> None:
    """The configuration file must describe the model the port runs."""
    have = dict(cfg.__dict__, head_dim=cfg.resolved_head_dim)
    bad = {k: (dims.get(k), have.get(k)) for k in MODEL_KEYS
           if dims.get(k, 0) != have.get(k)}
    bad.update({f"{k}_dtype": (v, getattr(cfg, f"{k}_dtype"))
                for k, v in dtypes.items() if k in ("param", "compute")
                and getattr(cfg, f"{k}_dtype") != v})
    if bad:
        raise ValueError(f"{cfg.name}: the configuration file and the port "
                         f"disagree (file, port): {bad}")


def buckets(chunk: int) -> List[int]:
    """Every padded chunk length a prompt can take: powers of two from 8
    up to the chunk."""
    out, b = [], 8
    while b < chunk:
        out.append(b)
        b *= 2
    return out + [chunk]


def stats_of(eng) -> dict:
    return dataclasses.asdict(eng.stats)


def delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def pct(values: List[float], q: float) -> float:
    """The q-quantile (0..1) by linear interpolation between order
    statistics."""
    v = sorted(values)
    if not v:
        return float("nan")
    x = q * (len(v) - 1)
    i = int(x)
    j = min(i + 1, len(v) - 1)
    return float(v[i] + (v[j] - v[i]) * (x - i))


class Run:
    """Drives one engine with one cell's traffic."""

    def __init__(self, eng, spec: Spec, traffic: Traffic, Request):
        self.eng, self.spec, self.traffic = eng, spec, traffic
        self.Request = Request
        self.infos: Dict[int, Info] = {}
        self.inflight: Dict[int, Info] = {}
        self.next_rid = 0
        self.next_k = 0
        self.window = int(spec.engine["window"])

    def send(self, prompt, budget, arrival) -> Info:
        req = self.Request(rid=self.next_rid, prompt=prompt,
                           max_new_tokens=int(budget))
        self.next_rid += 1
        info = Info(req, arrival)
        self.infos[req.rid] = self.inflight[req.rid] = info
        self.eng.add_request(req)
        return info

    def call(self) -> float:
        """One engine call; stamps first and last tokens; a closed loop's
        client sends its next request when its last one finishes."""
        self.eng.run_to_completion(max_ticks=self.window)
        t = time.perf_counter()
        for rid, info in list(self.inflight.items()):
            if info.t_first is None and info.req.out_tokens:
                info.t_first = t
            if info.req.done:
                info.t_done = t
                del self.inflight[rid]
                if self.spec.loop == "closed":
                    prompt, budget = self.traffic.request(self.next_k)
                    self.next_k += 1
                    self.send(prompt, budget, t)
        return t



class Slice:
    """The profiled slice of a traced run: it starts at the first call
    boundary ``lead`` seconds into the window and stops at the first one
    ``seconds`` later, both after a device synchronise, inside a
    ``perfbench.slice`` range."""

    def __init__(self, eng, rec: Optional[Recorder], dev, seconds: float,
                 lead: float):
        self.eng, self.rec, self.dev = eng, rec, dev
        self.seconds, self.lead = seconds, lead
        self.prof = None
        self.done = False
        self.acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            self.acts.append(torch.profiler.ProfilerActivity.CUDA)
        if rec is not None:
            # the profiler's first start is slow: pay it in set-up
            with torch.profiler.profile(activities=self.acts):
                torch.ones(1, device=dev).add_(1)
            _sync(dev)

    def tick(self, t: float, t_w0: float, final: bool = False) -> None:
        if self.rec is None or self.done:
            return
        if self.prof is None:
            if final or t < t_w0 + self.lead:
                return
            _sync(self.dev)
            self.prof = torch.profiler.profile(activities=self.acts)
            self.prof.__enter__()
            self.s0 = stats_of(self.eng)
            self.t0 = time.perf_counter()
            self.rec.in_slice = True
            self.range = torch.profiler.record_function(trace.SLICE)
            self.range.__enter__()
        elif final or t >= self.t0 + self.seconds:
            _sync(self.dev)
            self.range.__exit__(None, None, None)
            self.t1 = time.perf_counter()
            self.s1 = stats_of(self.eng)
            self.rec.in_slice = False
            self.prof.__exit__(None, None, None)
            self.done = True


def serve_open(run: "Run", spec: Spec, seconds: float, prof=None,
               rate: Optional[float] = None):
    """An open loop: requests sent at their scheduled arrivals, ``ramp_s``
    of them before the window, the window ``seconds`` long, then served
    (arrivals going on) until every request due in the window is done or
    ``drain_s`` has passed.  Returns (window start, window end, stats at
    both, the requests due in the window, the cut-off)."""
    t_s0 = time.perf_counter()
    times = run.traffic.arrivals(spec.ramp_s + seconds + spec.drain_s, rate)
    t_w0, t_w1 = t_s0 + spec.ramp_s, t_s0 + spec.ramp_s + seconds
    cut = t_w1 + spec.drain_s
    nxt = 0
    s0 = s1 = None
    due: List[Info] = []
    while True:
        now = time.perf_counter()
        if s0 is None and now >= t_w0:
            s0 = stats_of(run.eng)
        if s1 is None and now >= t_w1:
            s1 = stats_of(run.eng)
        while nxt < len(times) and t_s0 + times[nxt] <= now:
            prompt, budget = run.traffic.request(nxt)
            info = run.send(prompt, budget, t_s0 + float(times[nxt]))
            info.sent = now
            if t_w0 <= info.arrival < t_w1:
                due.append(info)
            nxt += 1
        if (now >= t_w1 and all(i.t_done is not None for i in due)) \
                or now >= cut:
            break
        if not run.inflight:
            if nxt >= len(times):
                break
            time.sleep(max(0.0, t_s0 + times[nxt] - now))
            continue
        t = run.call()
        if prof is not None:
            prof.tick(t, t_w0)
    s0 = s0 or stats_of(run.eng)
    s1 = s1 or stats_of(run.eng)
    return t_w0, t_w1, s0, s1, due, cut


def open_metrics(due: List[Info], cut: float):
    """(tails of the requests due in the window, how many failed).  A
    request not done at the cut-off failed; its times run to the
    cut-off."""
    ttft, tpot, late, failed = [], [], [], 0
    for i in due:
        failed += i.t_done is None
        first = i.t_first if i.t_first is not None else cut
        end = i.t_done if i.t_done is not None else cut
        ttft.append(first - i.arrival)
        tpot.append((end - first) / max(1, len(i.req.out_tokens) - 1))
        late.append(i.sent - i.arrival)
    e2e = dict(ttft_p95_ms=pct(ttft, 0.95) * 1e3,
               tpot_p95_ms=pct(tpot, 0.95) * 1e3,
               ttft_p50_ms=pct(ttft, 0.5) * 1e3,
               tpot_p50_ms=pct(tpot, 0.5) * 1e3,
               sent_late_max_ms=max(late, default=0.0) * 1e3)
    return e2e, failed


def warm(eng, Request, spec: Spec, vocab: int, seed: int) -> None:
    """One request for each prefill bucket the traffic can reach, each
    decoding one token, served to the end."""
    rng = np.random.default_rng([seed, 1])
    reqs = [Request(rid=-1 - i, prompt=rng.integers(0, vocab, size=b
                                                    ).astype(np.int32),
                    max_new_tokens=2)
            for i, b in enumerate(buckets(int(spec.engine["prefill_chunk"])))]
    for r in reqs:
        eng.add_request(r)
    eng.run_to_completion()


def build(cell_config: dict, seed: int, device, model_cfg=None):
    """(bundle, weights) as the launcher builds them, the weights drawn by
    the benchmark in the program's layout."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import RuntimeFlags
    from repro_torch.models import build as build_bundle
    from repro_torch.models.transformer import dtype_of

    cfg = model_cfg or ARCHS[cell_config["arch"]]
    dims = cell_config["model"]
    check_model(cfg, dims, cell_config["dtypes"])
    flags = RuntimeFlags(**cell_config["flags"])
    bundle = build_bundle(cfg, flags, device=device)
    params = weights.draw(dims, seed, dtype_of(cfg.param_dtype),
                          bundle.device)
    weights.check_against(params, bundle.abstract_params()[0])
    return bundle, params


def engine(bundle, params, spec: Spec, seed: int,
           rec: Optional[Recorder] = None):
    """The serving engine at the traffic's settings."""
    from repro_torch.serve import ServeEngine
    cls = ServeEngine if rec is None else traced_engine(ServeEngine, rec)
    e = spec.engine
    return cls(bundle, params, int(e["batch"]), int(e["max_len"]),
               window=int(e["window"]), prefill_chunk=int(e["prefill_chunk"]),
               seed=seed, device=str(bundle.device))


def run_cell(cell, seed: int, seconds: float, trace_on: bool, *,
             device: str = "cuda", t_start: Optional[float] = None,
             model_cfg=None, control: bool = False) -> dict:
    """One run.  Returns the raw records: end-to-end values, per-layer
    records, the check's readings, the device.  ``model_cfg`` replaces
    the port's configuration (the tests' small models); ``control`` also
    reads the fp8 control's gaps at the served positions."""
    from repro_torch.serve import Request

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    spec = cell.traffic
    dims = cell.config["model"]
    rec = Recorder(dev) if trace_on else None
    bundle, params = build(cell.config, seed, dev, model_cfg)
    eng = engine(bundle, params, spec, seed, rec)
    vocab = dims["vocab_size"]
    warm(eng, Request, spec, vocab, seed)
    if rec is not None:
        rec.spans.clear()
    traffic = Traffic(spec, seed, vocab)
    run = Run(eng, spec, traffic, Request)

    prof = Slice(eng, rec, dev, spec.profile_seconds,
                 lead=min(2.0, 0.2 * seconds))
    if spec.loop == "closed":
        for i in range(spec.clients):
            prompt, budget = traffic.initial(i)
            run.send(prompt, budget, time.perf_counter())
        first = list(run.infos.values())
        while any(not i.req.out_tokens for i in first):
            run.call()
        _sync(dev)
        h0 = host_sample()
        t_w0 = time.perf_counter()
        s0, tok0 = stats_of(eng), eng.stats.tokens_out
        t, marks = t_w0, [(t_w0, tok0)]
        while t < t_w0 + seconds:
            t = run.call()
            marks.append((t, eng.stats.tokens_out))
            prof.tick(t, t_w0)
        t_w1 = t
        s1 = stats_of(eng)
        host_rates = fifths(marks)
        due = [i for i in run.infos.values()
               if i.t_done is not None and t_w0 <= i.t_done <= t_w1]
        e2e = dict(tokens_per_s=(s1["tokens_out"] - tok0) / (t_w1 - t_w0))
        attempted, failed = len(due) + len(run.inflight), 0
    else:
        h0, host_rates = host_sample(), []
        t_w0, t_w1, s0, s1, due, cut = serve_open(run, spec, seconds, prof)
        e2e, failed = open_metrics(due, cut)
        attempted = len(due)
        due = [i for i in due if i.t_done is not None]
    host = dict(host_delta(h0, host_sample()),
                tokens_per_s_fifths=host_rates)
    prof.tick(float("inf"), t_w0, final=True)
    _sync(dev)
    setup_s = t_w0 - t_start
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    live_kv = eng.live_kv_bytes_peak()
    window_stats = delta(s0, s1)

    records = None
    if rec is not None:
        sl = {}
        if prof.prof is not None:
            sl = trace.from_profiler(prof.prof, {K1: K1})
            sl["stats"] = delta(prof.s0, prof.s1)
            sl["wall_s"] = prof.t1 - prof.t0
            sl["ticks"] = [c for sp in rec.spans
                           if sp.in_slice and sp.name == "decode_window"
                           for c in sp.contexts]
            sl["chunks"] = [(sp.offset, sp.length) for sp in rec.spans
                            if sp.in_slice and sp.name == "prefill_chunk"]
        win = [sp for sp in rec.spans
               if t_w0 <= sp.t0 <= t_w1 and not sp.in_slice]
        records = dict(dims=dims, window_stats=window_stats,
                       live_kv_bytes_peak=live_kv,
                       kv_itemsize=torch.empty(0, dtype=getattr(
                           torch, cell.config["dtypes"]["compute"])
                       ).element_size(),
                       decode_windows=[(sp.t1 - sp.t0, sp.ticks) for sp in win
                                       if sp.name == "decode_window"
                                       and sp.ticks],
                       prefill_chunks=[sp.t1 - sp.t0 for sp in win
                                       if sp.name == "prefill_chunk"],
                       slice=sl)

    # -- the output check, after the window, with the engine freed
    t_c0 = time.perf_counter()
    del eng, run.eng, prof.eng, bundle
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = check_outputs(cell, params, due, seed, dev, control)
    readings["check_s"] = time.perf_counter() - t_c0
    return dict(e2e=e2e, setup_s=setup_s, attempted=attempted, failed=failed,
                window_s=t_w1 - t_w0, window_stats=window_stats, host=host,
                memory_peak_bytes=int(peak), live_kv_bytes_peak=int(live_kv),
                records=records, readings=readings)


def host_sample() -> dict:
    """This process's CPU seconds and involuntary context switches."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return dict(t=time.perf_counter(), cpu_s=ru.ru_utime + ru.ru_stime,
                nivcsw=ru.ru_nivcsw)


def fifths(marks) -> List[float]:
    """Tokens a second in each fifth of the window, from (time, tokens out)
    at each call's return: whether a run slows inside its window."""
    t0, t1 = marks[0][0], marks[-1][0]
    out = []
    for k in range(5):
        lo, hi = t0 + k * (t1 - t0) / 5, t0 + (k + 1) * (t1 - t0) / 5
        sel = [m for m in marks if lo <= m[0] <= hi]
        if len(sel) > 1 and sel[-1][0] > sel[0][0]:
            out.append((sel[-1][1] - sel[0][1]) / (sel[-1][0] - sel[0][0]))
    return out


def host_delta(a: dict, b: dict) -> dict:
    """What this process did on the host between two samples: the share
    of a CPU it used (near 1: the host issue is the bottleneck)."""
    return dict(cpu_share=(b["cpu_s"] - a["cpu_s"]) / (b["t"] - a["t"]),
                involuntary_switches=b["nivcsw"] - a["nivcsw"])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sample(done: List[Info], n: int, seed: int) -> List[Info]:
    """``n`` finished requests drawn from the seed, the one with the most
    served tokens and the one with the longest context among them."""
    if not done:
        return []
    most = max(done, key=lambda i: len(i.req.out_tokens))
    longest = max(done, key=lambda i: len(i.req.prompt)
                  + len(i.req.out_tokens))
    picked = {id(most): most, id(longest): longest}
    rng = np.random.default_rng([seed, 2])
    for j in rng.permutation(len(done)):
        if len(picked) >= n:
            break
        picked.setdefault(id(done[j]), done[j])
    return list(picked.values())


def check_outputs(cell, params: dict, done: List[Info], seed: int,
                  dev: torch.device, control: bool = False) -> dict:
    """The widest and the mean logit gap of the served tokens of a sample
    of finished requests against the float32 reference; with
    ``control``, the fp8 control's at the same positions."""
    ref.exact_float32()
    kind = importlib.import_module(
        f"perfbench.reference.{cell.config['reference']}")
    dims = cell.config["model"]
    picked = sample(done, int(cell.check["sample_requests"]), seed)
    w_head = ref.head(params)
    gap, cgap, tokens, gsum, csum = 0.0, 0.0, 0, 0.0, 0.0
    with torch.no_grad():
        for info in picked:
            prompt = torch.as_tensor(np.asarray(info.req.prompt),
                                     dtype=torch.long, device=dev)
            served = torch.as_tensor(info.req.out_tokens, dtype=torch.long,
                                     device=dev)
            g, c = ref.served_gaps(params, dims, kind.ffn, prompt, served,
                                   ref.fp8_linear if control else None,
                                   w_head=w_head)
            gap = max(gap, float(g.max()))
            gsum += float(g.sum())
            tokens += int(served.numel())
            if c is not None:
                cgap = max(cgap, float(c.max()))
                csum += float(c.sum())
    out = dict(logit_gap_max=gap, logit_gap_mean=gsum / max(tokens, 1),
               tokens_compared=tokens, requests_compared=len(picked))
    if control:
        out.update(control_gap_max=cgap,
                   control_gap_mean=csum / max(tokens, 1))
    return out


GAPS = ("logit_gap_max", "logit_gap_mean")


def verdict(cell, readings: dict) -> Dict[str, dict]:
    """Each compared number beside its limit and the rule that holds it:
    the gaps that the cell's check file gives a limit, and the tokens
    compared."""
    lim = cell.check
    out = {g: dict(value=readings[g], limit=lim[g], rule="<=")
           for g in GAPS if g in lim}
    if not out:
        raise KeyError(f"{cell.name}: the check file limits none of {GAPS}")
    out["tokens_compared"] = dict(value=readings["tokens_compared"],
                                  limit=lim["min_tokens"], rule=">=")
    return out


def passed(checks: Dict[str, dict]) -> bool:
    ok = True
    for c in checks.values():
        v, lim = c["value"], c["limit"]
        ok &= (v <= lim) if c["rule"] == "<=" else (v >= lim)
    return bool(ok)
