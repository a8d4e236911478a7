"""Serving from a checkpoint (``launch/serve.py --ckpt``) against the
reference, on the CPU.

One module-scoped directory per config, written by the reference's
``CheckpointManager`` from the reference's own init:

- the port's launcher and the reference's print the same counts on it
  (tokens_out, prefills, decode_steps; at TP=2 over ``cpu,cpu`` against
  the reference's one device, and under the disaggregated topology);
- the port's restore gives the reference restore's leaves bit for bit,
  and an engine over them the reference engine's greedy tokens; the
  launcher's TP=2 pool over ``cpu,cpu`` and its disaggregated pools (TP=1
  and TP=2) over the restored tree drain the reference's one-device
  pools' greedy tokens on the reference's restored tree;
- a float32 checkpoint through a bfloat16 bundle keeps float32 leaves in
  both packages, and drains to the reference's tokens and counters;
- a checkpoint the port's trainer writes (``launch/train.py --ckpt``)
  serves through the port's launcher;
- a directory that is missing, or holds no step, is a clear error.
"""
import re

import jax
import numpy as np
import pytest

import repro.serve as J
import repro_torch.serve as T
from repro.configs import ARCHS as J_ARCHS
from repro.configs import override as j_override
from repro.configs import smoke_config as j_smoke
from repro.launch.serve import build_disagg_pool as j_build_disagg_pool
from repro.launch.serve import build_pool as j_build_pool
from repro.launch.serve import main as j_main
from repro.models import RuntimeFlags as JFlags
from repro.models import build as j_build
from repro.train import CheckpointManager as JCheckpointManager
from repro_torch.bridge import flatten
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import override as t_override
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import RuntimeFlags as TFlags
from repro_torch.models import build as t_build

# the launchers' flags (serve.py's, in both packages)
J_LAUNCH = dict(attn_impl="chunked", attn_bq=64, attn_bkv=64,
                moe_impl="dense", loss_chunk=64)
T_LAUNCH = dict(attn_impl="chunked", attn_bq=64, attn_bkv=64,
                moe_impl="dense")
ARGS = ["--smoke", "--requests", "5", "--batch", "2", "--max-new", "4",
        "--max-len", "64"]
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def _write(root, arch, seed):
    """A reference checkpoint (``dict(params=...)``, the trainer's keys)
    of smoke ``arch`` drawn by the reference's init; returns its dir."""
    jb = j_build(j_smoke(J_ARCHS[arch]), JFlags(**J_LAUNCH))
    d = str(root / arch)
    mgr = JCheckpointManager(d, async_save=False)
    mgr.save(7, dict(params=jb.init(jax.random.PRNGKey(seed))))
    return d


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    return {arch: _write(root, arch, seed)
            for arch, seed in (("gemma-2b", 3), ("phi4-mini-3.8b", 5))}


def _counts(text):
    """tokens_out, prefills and decode_steps of a launcher's summary."""
    line = next(ln for ln in text.splitlines() if "decode_steps=" in ln)
    got = dict(re.findall(r"(prefills|decode_steps)=(\d+)", line))
    got["tokens_out"] = re.search(r"(\d+) tokens in", line).group(1)
    return got


LAYOUTS = {
    # name: (arch, the port's extra arguments, both launchers' arguments)
    "tp1": ("gemma-2b", ["--device", "cpu"], []),
    "tp2": ("phi4-mini-3.8b", ["--tp", "2", "--devices", "cpu,cpu"], []),
    "disagg": ("gemma-2b", ["--device", "cpu"],
               ["--topology", "disagg", "--route", "disagg"]),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_launcher_serves_a_reference_checkpoint(layout, ckpts, capsys):
    """At TP=2 the port's two shards give the reference's one-device
    counts (tier-1's jax has one device).  These counts follow from the
    scheduling alone; the tokens that these layouts serve from the
    restored tree are held in
    :func:`test_sharded_pools_serve_the_restored_tree`."""
    arch, port, both = LAYOUTS[layout]
    argv = ["--arch", arch, "--ckpt", ckpts[arch]] + ARGS + both
    assert j_main(argv) == 0
    want = capsys.readouterr().out
    assert launch_serve.main(argv + port) == 0
    got = capsys.readouterr().out
    assert _counts(got) == _counts(want)
    assert _counts(got)["tokens_out"] == "20"
    if layout == "disagg":
        transfers = [ln for ln in got.splitlines() if ln.startswith("disagg:")]
        assert transfers == [ln for ln in want.splitlines()
                             if ln.startswith("disagg:")]


def _drain(eng, Request, vocab):
    rng = np.random.default_rng(9)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, vocab, size=int(rng.integers(4, 24))).astype(np.int32),
        max_new_tokens=6) for i in range(4)]
    for r in reqs:
        eng.add_request(r)
    eng.run_to_completion()
    return [list(r.out_tokens) for r in reqs]


STATS = ("tokens_out", "prefills", "decode_steps", "decode_dispatches",
         "prefill_chunks", "pages_peak")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16-bundle"])
def test_restore_and_drain_equal_the_reference(dtype, ckpts):
    """The leaves restored bit for bit (each in its saved dtype, float32
    here), and a paged engine over them drains the reference engine's
    greedy tokens and counters; ``bfloat16-bundle`` serves the float32
    tree through a bfloat16 config, as the full-width launcher serves a
    float32 training checkpoint."""
    d = ckpts["gemma-2b"]
    jcfg, tcfg = j_smoke(J_ARCHS["gemma-2b"]), t_smoke(T_ARCHS["gemma-2b"])
    if dtype != "float32":
        jcfg, tcfg = j_override(jcfg, **BF16), t_override(tcfg, **BF16)
    jb = j_build(jcfg, JFlags(**J_LAUNCH))
    tb = t_build(tcfg, TFlags(**T_LAUNCH), device="cpu")
    abstract, _ = jb.abstract_params()
    want = JCheckpointManager(d).restore(None, dict(params=abstract))["params"]
    got = launch_serve.restore_params(tb, d)
    jleaves = dict(jax.tree_util.tree_leaves_with_path(want))
    tleaves = flatten(got)
    assert len(tleaves) == len(jleaves)
    for path, w in jleaves.items():
        key = ".".join(str(p.key) for p in path)
        g = tleaves[key]
        assert str(g.dtype).replace("torch.", "") == str(w.dtype) == "float32"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    kw = dict(batch_size=2, max_len=64, cache_backend="paged")
    jeng = J.ServeEngine(jb, want, **kw)
    teng = T.ServeEngine(tb, got, device="cpu", **kw)
    assert (_drain(teng, T.Request, tcfg.vocab_size)
            == _drain(jeng, J.Request, jcfg.vocab_size))
    for f in STATS:
        assert getattr(teng.stats, f) == getattr(jeng.stats, f), f


# name: (arch, the port's pool builder and its arguments); the reference
# builds the same pool on its one device (tp=1).  Smoke gemma-2b has one
# kv head, so TP=2 serves phi4-mini.
POOLS = {
    "tp2": ("phi4-mini-3.8b", "pool", dict(tp=2, devices=["cpu", "cpu"])),
    "disagg": ("gemma-2b", "disagg", dict(tp=1)),
    "disagg-tp2": ("phi4-mini-3.8b", "disagg",
                   dict(tp=2, devices=["cpu", "cpu"])),
}


def _pool_tokens(pool, Request, vocab, run):
    rng = np.random.default_rng(9)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, vocab, size=int(rng.integers(4, 24))).astype(np.int32),
        max_new_tokens=6) for i in range(5)]
    for r in reqs:
        pool.submit(r)
    run(pool)
    return [list(r.out_tokens) for r in reqs]


@pytest.mark.parametrize("layout", sorted(POOLS))
def test_sharded_pools_serve_the_restored_tree(layout, ckpts):
    """The launcher's TP=2 and disaggregated pools over the port's
    restored tree drain the reference's greedy tokens on the reference's
    restored tree: the sharded engines cut the restored leaves as they cut
    a drawn tree, and the hand-off ships their pages."""
    arch, kind, kw = POOLS[layout]
    d = ckpts[arch]
    jcfg, tcfg = j_smoke(J_ARCHS[arch]), t_smoke(T_ARCHS[arch])
    jb = j_build(jcfg, JFlags(**J_LAUNCH))
    tb = t_build(tcfg, TFlags(**T_LAUNCH), device="cpu")
    abstract, _ = jb.abstract_params()
    want = JCheckpointManager(d).restore(None, dict(params=abstract))["params"]
    got = launch_serve.restore_params(tb, d)
    eng_kw = dict(batch_size=2, max_len=64, cache_backend="paged")
    if kind == "pool":
        jpool = j_build_pool(jb, want, **eng_kw)
        tpool = launch_serve.build_pool(tb, got, device="cpu", **kw,
                                        **eng_kw)
        run = lambda p: p.drain()                            # noqa: E731
    else:
        jpool = j_build_disagg_pool(jb, want, disagg_config=J.DisaggConfig(
            force="disagg"), **eng_kw)
        tpool = launch_serve.build_disagg_pool(
            tb, got, disagg_config=T.DisaggConfig(force="disagg"),
            device="cpu", **kw, **eng_kw)
        run = lambda p: p.run()                              # noqa: E731
    want_tokens = _pool_tokens(jpool, J.Request, jcfg.vocab_size, run)
    assert _pool_tokens(tpool, T.Request, tcfg.vocab_size, run) == want_tokens
    assert all(e.tp == kw["tp"] for e in tpool.engines)
    if kind == "disagg":
        assert tpool.stats().prefill_imports >= 1
        assert tpool.stats().prefill_imports == jpool.stats().prefill_imports


def test_launcher_serves_the_port_trainers_checkpoint(tmp_path, capsys):
    d = str(tmp_path / "run")
    assert launch_train.main(["--arch", "gemma-2b", "--smoke", "--device",
                              "cpu", "--steps", "2", "--seq", "32",
                              "--batch", "2", "--ckpt", d]) == 0
    capsys.readouterr()
    assert launch_serve.main(["--arch", "gemma-2b", "--ckpt", d,
                              "--device", "cpu"] + ARGS) == 0
    assert _counts(capsys.readouterr().out)["tokens_out"] == "20"


def test_launcher_refuses_a_directory_without_a_step(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoints in"):
        launch_serve.main(["--arch", "gemma-2b", "--ckpt", str(tmp_path),
                           "--device", "cpu"] + ARGS)
    missing = str(tmp_path / "missing")
    with pytest.raises(SystemExit, match="no checkpoint directory"):
        launch_serve.main(["--arch", "gemma-2b", "--ckpt", missing,
                           "--device", "cpu"] + ARGS)
    with pytest.raises(FileNotFoundError):
        launch_serve.restore_params(
            t_build(t_smoke(T_ARCHS["gemma-2b"]), device="cpu"), missing)
    assert not (tmp_path / "missing").exists()
