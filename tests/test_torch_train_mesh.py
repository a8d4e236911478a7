"""FSDP x TP training, the elastic restore, the sharded prefill/decode
steps and the meta-device dry-run of the port, held against the
reference on the CPU (one process drives every shard; the mesh's devices
are the CPU repeated).

- ``tests/_md_scenarios.py::scenario_sharded_train`` on a (4, 2) mesh
  over ``["cpu"] * 8`` under ``fsdp_tp`` for smoke gemma2-27b,
  phi4-mini-3.8b and gemma-2b (one kv head): one step against the
  reference's one-device step on the same bridged weights and batch
  (loss within 1e-6 relative, ``grad_norm`` within 1e-5, AdamW's first
  moment within 1e-4 of each leaf's largest); every leaf stored in the
  blocks the reference's ``spec_for`` gives for {data: 4, model: 2}, no
  two blocks sharing storage; six steps on one batch make gemma2-27b's
  loss fall;
- FSDP and DP on (4, 1) for smoke granite-moe-3b-a800m (its load-balance
  loss over the whole batch), recurrentgemma-9b and seamless-m4t-medium
  against the reference the same way, and a (2, 2) step of each;
- ``fsdp_tp_sp`` gives ``fsdp_tp``'s numbers, and two microbatches one
  microbatch's, on the mesh;
- ``scenario_elastic_reshard``: a (4, 2) checkpoint restores onto (2, 2)
  exactly, a loss runs there, and the reference's manager reads the same
  files;
- ``scenario_decode_sharded`` and a prefill step on (4, 2): logits within
  1e-5 of the reference's ``prefill``/``decode_step`` under a scalar and
  a per-slot ``pos``, the cache cut on its batch dim;
- the dry-run of a smoke cell over small meta meshes: argument bytes are
  the blocks' bytes, the per-device FLOPs add up to ``FlopCounterMode``'s
  total, which equals the one-device step's, and the ``roofline`` sweep
  reads the artifact when it exists and falls back when it does not;
- the launcher over ``--devices cpu,cpu,cpu,cpu`` and its shortfall.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import smoke_config as j_smoke
from repro.dist import POLICIES as J_POLICIES
from repro.dist.sharding import spec_for as j_spec_for
from repro.dist.steps import make_train_step as j_make_train_step
from repro.models import RuntimeFlags as JFlags
from repro.models import build as j_build
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as j_adamw
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import Trainer as JTrainer
from repro_torch.bench import run_sweeps
from repro_torch.bridge import flatten, params_from_numpy
from repro_torch.configs import ARCHS, ShapeCell, smoke_config
from repro_torch.dist import POLICIES
from repro_torch.dist.sharding import (Sharded, assemble, assemble_tree,
                                       cut_tree)
from repro_torch.dist.steps import (make_decode_step, make_prefill_step,
                                    make_train_step, shard_state)
from repro_torch.launch import dryrun
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh
from repro_torch.models import RuntimeFlags, build
from repro_torch.optim import AdamWConfig
from repro_torch.tree import leaves
from repro_torch.train import TrainConfig, Trainer

# tests/_md_scenarios.py's flags
FLAGS = dict(attn_impl="chunked", attn_bq=16, attn_bkv=16, moe_impl="dense",
             loss_chunk=16)
B, S = 8, 32                   # the scenarios' cell: batch 8, seq 32


def _mesh(data, model, dev="cpu"):
    return Mesh(("data", "model"), (data, model), (dev,) * (data * model))


def _j_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.enc_dec:
        return dict(frames=rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32), dec_tokens=tok, labels=tok)
    return dict(tokens=tok, labels=tok)


def _nest(flat):
    """A dotted-key dict as the nested tree both packages keep params in."""
    out = {}
    for k, v in flat.items():
        d = out
        parts = k.split(".")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def _weights(arch):
    """Seed-0 weights of the smoke config as numpy, drawn by the port (the
    same tree in both packages)."""
    cfg = smoke_config(ARCHS[arch])
    p = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    return _nest({k: v.detach().numpy() for k, v in flatten(p).items()})


def _reference_step(arch, batch):
    """The reference's one-device step from the same weights: (weights,
    loss, grad_norm, the first moment's leaves)."""
    jb = j_build(j_smoke(J_ARCHS[arch]), JFlags(**FLAGS))
    p0 = _weights(arch)
    step, p_sh, o_sh, _ = j_make_train_step(
        jb, _j_mesh(), J_POLICIES["fsdp_tp"], JAdamWConfig(lr=1e-3))
    with jax.set_mesh(_j_mesh()):
        jp = JTrainer._put_tree(jax.tree.map(jnp.asarray, p0), p_sh)
        jo = JTrainer._put_tree(j_adamw.init(jp), o_sh)
        _, jo, jm = step(jp, jo, jax.tree.map(jnp.asarray, batch))
    return p0, float(jm["loss"]), float(jm["grad_norm"]), flatten(_np(jo.m))


def _port_step(arch, p0, batch, mesh, policy="fsdp_tp", micro=1):
    cfg = smoke_config(ARCHS[arch])
    bundle = build(cfg, RuntimeFlags(**FLAGS), device="cpu")
    step, p_sh, _, _ = make_train_step(bundle, mesh, POLICIES[policy],
                                       AdamWConfig(lr=1e-3),
                                       microbatches=micro)
    params, opt = shard_state(params_from_numpy(p0, cfg, "cpu"), p_sh, mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params, opt, m = step(params, opt, tb)
    return params, opt, m, (step, tb)


def _holds(m, opt, loss, gnorm, m_ref, tol_loss=1e-6):
    assert abs(float(m["loss"]) - loss) <= tol_loss * abs(loss), (
        float(m["loss"]), loss)
    np.testing.assert_allclose(float(m["grad_norm"]), gnorm, rtol=1e-5)
    got = flatten(assemble_tree(opt.m))
    assert got.keys() == m_ref.keys()
    for k, w in m_ref.items():
        scale = float(np.max(np.abs(w))) or 1.0
        assert float(np.max(np.abs(got[k].numpy() - w))) <= 1e-4 * scale, k


def _storages(*trees):
    return [b.untyped_storage().data_ptr() for t in trees
            for x in leaves(t) for b in x.blocks]


class _Sizes:
    shape = {"data": 4, "model": 2}


@pytest.mark.parametrize("arch", ["gemma2-27b", "phi4-mini-3.8b",
                                  "gemma-2b"])
def test_fsdp_tp_step_matches_reference_and_trains(arch):
    batch = _batch(smoke_config(ARCHS[arch]))
    p0, loss, gnorm, m_ref = _reference_step(arch, batch)
    params, opt, m, (step, tb) = _port_step(arch, p0, batch, _mesh(4, 2))
    _holds(m, opt, loss, gnorm, m_ref)
    # every leaf in the blocks of the reference's spec_for, each with its
    # own storage (the eight shards share one device)
    specs = build(smoke_config(ARCHS[arch]), device="cpu").param_specs()
    for (k, x), ax in zip(flatten(params).items(),
                          flatten(specs).values()):
        assert isinstance(x, Sharded)
        want = tuple(j_spec_for(tuple(x.shape), ax,
                                J_POLICIES["fsdp_tp"].param_rules, _Sizes))
        assert x.spec == want, k
        sizes = [int(np.prod([_Sizes.shape[a] for a in
                              ((e,) if isinstance(e, str) else e or ())]))
                 for e in want]
        assert len(x.blocks) == int(np.prod(sizes))
        for b in x.blocks:
            assert tuple(b.shape) == tuple(n // s for n, s in
                                           zip(x.shape, sizes)), k
    assert any(len(x.blocks) > 1 for x in leaves(params))
    ptrs = _storages(params, opt.m, opt.v)
    assert len(set(ptrs)) == len(ptrs)
    if arch != "gemma2-27b":             # the scenario's arch trains on
        return
    losses = [float(m["loss"])]
    for _ in range(5):
        params, opt, m = step(params, opt, tb)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "recurrentgemma-9b",
                                  "seamless-m4t-medium"])
def test_fsdp_and_dp_over_the_data_axis_match_reference(arch):
    batch = _batch(smoke_config(ARCHS[arch]))
    p0, loss, gnorm, m_ref = _reference_step(arch, batch)
    for policy in ("fsdp_tp", "dp"):
        _, opt, m, _ = _port_step(arch, p0, batch, _mesh(4, 1), policy)
        _holds(m, opt, loss, gnorm, m_ref)
        if arch == "granite-moe-3b-a800m":
            assert float(m["aux"]) > 0
    # and at model 2 (tests/test_torch_tp_families.py holds it against
    # the reference's step across both meshes)
    _, opt, m, _ = _port_step(arch, p0, batch, _mesh(2, 2))
    _holds(m, opt, loss, gnorm, m_ref)


def test_sequence_parallel_and_microbatches_keep_the_numbers():
    arch = "gemma2-27b"
    batch = _batch(smoke_config(ARCHS[arch]), seed=3)
    p0 = _weights(arch)
    runs = {(pol, mi): _port_step(arch, p0, batch, _mesh(2, 2), pol, mi)
            for pol, mi in (("fsdp_tp", 1), ("fsdp_tp_sp", 1),
                            ("fsdp_tp", 2))}
    _, o1, m1, _ = runs["fsdp_tp", 1]
    m_ref = {k: v.numpy() for k, v in flatten(assemble_tree(o1.m)).items()}
    for key in (("fsdp_tp_sp", 1), ("fsdp_tp", 2)):
        _, o, m, _ = runs[key]
        _holds(m, o, float(m1["loss"]), float(m1["grad_norm"]), m_ref)


def test_elastic_restore_onto_a_smaller_mesh(tmp_path):
    """scenario_elastic_reshard: (4, 2) -> (2, 2), atol 0."""
    cfg = smoke_config(ARCHS["phi4-mini-3.8b"])
    bundle = build(cfg, RuntimeFlags(**FLAGS), device="cpu")
    tr = Trainer(bundle, ShapeCell("s", "train", S, B), _mesh(4, 2),
                 POLICIES["fsdp_tp"], AdamWConfig(lr=1e-3),
                 TrainConfig(steps=2, ckpt_dir=str(tmp_path), ckpt_every=2,
                             log_every=1))
    tr.run()
    p_a, o_a = tr._final
    tr_b = Trainer(bundle, ShapeCell("s", "train", S, B), _mesh(2, 2),
                   POLICIES["fsdp_tp"], AdamWConfig(lr=1e-3),
                   TrainConfig(steps=4, ckpt_dir=str(tmp_path)))
    p_b, o_b, start = tr_b.restore_state()
    assert start == 2 and int(o_b.step) == 2
    for (k, a), b in zip(flatten(p_a).items(), flatten(p_b).values()):
        assert b.mesh.shape == {"data": 2, "model": 2}, k
        assert torch.equal(assemble(a).detach(), assemble(b)), k
    for a, b in zip(leaves(o_a.m), leaves(o_b.m)):
        assert torch.equal(assemble(a), assemble(b))
    zeros = torch.zeros((4, S), dtype=torch.int32)
    flags = RuntimeFlags(**FLAGS, mesh=_mesh(2, 2), policy=POLICIES["fsdp_tp"])
    loss, _ = build(cfg, flags, device="cpu").train_loss(
        p_b, dict(tokens=zeros, labels=zeros))
    assert bool(torch.isfinite(loss))
    # the reference's manager reads the files the mesh run wrote
    jb = j_build(j_smoke(J_ARCHS["phi4-mini-3.8b"]), JFlags(**FLAGS))
    abs_params, _ = jb.abstract_params()
    got = JCheckpointManager(str(tmp_path)).restore(
        None, dict(params=abs_params))["params"]
    for k, w in flatten(_np(got)).items():
        np.testing.assert_array_equal(assemble(flatten(p_a)[k]).detach()
                                      .numpy(), w)


def test_sharded_prefill_and_decode_match_reference():
    """scenario_decode_sharded plus a prefill, (4, 2), float32."""
    arch = "gemma2-27b"
    jb = j_build(j_smoke(J_ARCHS[arch]), JFlags(**FLAGS))
    p0 = _weights(arch)
    cfg = smoke_config(ARCHS[arch])
    bundle = build(cfg, RuntimeFlags(**FLAGS), device="cpu")
    mesh = _mesh(4, 2)
    cell = ShapeCell("d", "decode", 64, B)
    pre, p_sh = make_prefill_step(bundle, mesh, POLICIES["fsdp_tp"], cell)
    dec, _, c_sh = make_decode_step(bundle, mesh, POLICIES["fsdp_tp"], cell)
    params = cut_tree(params_from_numpy(p0, cfg, "cpu"), p_sh, mesh)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab_size, (B, 24)).astype(np.int32)
    cache, logits = pre(params, dict(tokens=torch.from_numpy(tok)))
    _, jl = jb.prefill(p0, dict(tokens=jnp.asarray(tok)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-5)
    k0 = cache["blocks"]["p0"]["k"]
    assert isinstance(k0, Sharded) and len(k0.blocks) == 4
    assert k0.blocks[0].shape[1] == B // 4
    jcache = jb.init_cache(B, 64)
    tcache = cut_tree(bundle.init_cache(B, 64), c_sh, mesh)
    for pos in (5, np.arange(B, dtype=np.int32) + 3):
        t = tok[:, :1]
        jlog, jcache = jb.decode_step(p0, jcache, jnp.asarray(t),
                                      jnp.asarray(pos, jnp.int32))
        tlog, tcache2 = dec(params, tcache, torch.from_numpy(t),
                            torch.as_tensor(pos, dtype=torch.int32))
        assert tcache2 is tcache
        assert tlog.shape == (B, cfg.vocab_size)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-5)


def test_dry_run_accounts_a_smoke_cell(tmp_path, monkeypatch):
    cfg = smoke_config(ARCHS["gemma2-27b"])
    cell = ShapeCell("train_smoke", "train", S, B)
    flags = RuntimeFlags(**FLAGS)
    traces = {}
    for shape in ((1, 1), (2, 2)):
        mesh = _mesh(*shape, dev="meta")
        tr = dryrun.trace_cell(cfg, cell, mesh, POLICIES["fsdp_tp"], flags)
        assert sum(tr.flops) == tr.total_flops
        traces[shape] = tr
    one, four = traces[(1, 1)], traces[(2, 2)]
    assert abs(four.total_flops - one.total_flops) <= 0.01 * one.total_flops
    # argument bytes: the blocks of params, m and v (float32) and the
    # batch slices, exactly
    params, _ = build(cfg, flags, device="meta").abstract_params()
    nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
    nelem = sum(t.numel() for t in leaves(params))
    batch = 2 * B * S * 4
    assert sum(one.args) == nbytes + 8 * nelem + 4 + batch
    assert sum(four.args) == sum(one.args)
    assert all(p >= a for p, a in zip(four.peak, four.args))
    assert max(four.args) < sum(four.args) / 2
    assert sum(four.recv) > 0 and one.recv == [0]
    rec = dryrun.run_cell(cfg, cell, pods="single", roofline=False,
                          meshes={"single_pod": _mesh(2, 2, dev="meta")})
    assert rec["status"] == "ok" and rec["roofline"]["dominant"]
    m = rec["meshes"]["single_pod"]
    assert m["argument_bytes_by_device"] == four.args and m["fits_80g"]
    # the roofline sweep reads the artifact, and falls back without it
    art = tmp_path / "dryrun_torch.json"
    import json
    art.write_text(json.dumps([rec]))
    monkeypatch.setenv("DRYRUN_TORCH_JSON", str(art))
    rows = run_sweeps(["roofline"], fast=True, echo=False,
                      device="cpu").by_sweep("roofline")
    assert [r.name for r in rows] == ["roofline_gemma2-27b_train_smoke"]
    assert rows[0].extras["source"] == "dryrun_torch.json"
    assert rows[0].extras["fits_80g_1pod"] is True
    monkeypatch.setenv("DRYRUN_TORCH_JSON", str(tmp_path / "missing.json"))
    rows = run_sweeps(["roofline"], fast=True, echo=False,
                      device="cpu").by_sweep("roofline")
    assert {r.extras["source"] for r in rows} == {"analytic_fallback"}


def test_launcher_trains_on_a_repeated_cpu_group(capsys):
    assert launch_train.main(
        ["--arch", "gemma-2b", "--smoke", "--device", "cpu",
         "--mesh-model", "2", "--devices", "cpu,cpu,cpu,cpu", "--steps", "3",
         "--seq", "32", "--batch", "4"]) == 0
    assert "finished at step 3 on cpu" in capsys.readouterr().out
    args = launch_train.parser().parse_args(
        ["--arch", "gemma-2b", "--smoke", "--mesh-model", "2", "--devices",
         "cpu,cpu,cpu,cpu"])
    assert dict(launch_train.mesh_of(args).shape) == {"data": 2, "model": 2}
    if torch.cuda.device_count() < 2:
        with pytest.raises(SystemExit, match="needs 2 devices"):
            launch_train.main(["--arch", "gemma-2b", "--smoke",
                               "--mesh-model", "2"])
