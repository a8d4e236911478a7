"""Data-parallel training of the port on the CPU, one process driving
every shard (``repro_torch.dist.dp_shardmap``), and the entry points of
sharded training that waited for ROADMAP A10b.

- uncompressed DP over ``["cpu", "cpu"]`` equals the one-device step on
  the full batch (smoke gemma-2b: loss within 1e-6, the gradient norm
  within 1e-5, every param within 2 lr, the most one sign flip of a
  near-zero gradient moves it, and fewer than 0.1% of them apart by more
  than 1e-6);
- compressed DP equals a computation made of the reference's pieces:
  ``repro.optim.compress.ef_compress`` of each half's gradient (taken by
  ``jax.grad``), their mean and ``repro.optim.adamw.update``, over three
  steps of a least-squares problem (params and residuals within 1e-5);
- the reference's ``scenario_dp_compression`` (tests/_md_scenarios.py)
  over ``["cpu"] * 8``: both runs converge by more than 100x and the
  compressed one ends within 5x of the uncompressed one;
- the refusals of ``tests/test_sharding.py``;
- ``make_train_step`` on a (1, 2) mesh, ``train_loss`` under a TP=2
  bundle and the launcher with ``--mesh-model 2 --devices cpu,cpu``,
  which refused with a message naming A10b, train: the mesh's loss and
  ``grad_norm`` equal the one-device step's, and the TP bundle's
  gradients reach its whole params (tests/test_torch_train_mesh.py
  holds the mesh against the reference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as j_adamw
from repro.optim import compress as j_compress
from repro_torch.bridge import flatten
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.dist import POLICIES
from repro_torch.dist.dp_shardmap import (init_error_feedback,
                                          make_dp_train_step)
from repro_torch.dist.steps import make_train_step, shard_state
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh
from repro_torch.models import RuntimeFlags, build
from repro_torch.optim import AdamWConfig, adamw

FLAGS = RuntimeFlags(attn_impl="chunked", attn_bq=16, attn_bkv=16,
                     moe_impl="dense", loss_chunk=16)


def _mesh(n, axes=("data",)):
    return Mesh(axes, (n,), ("cpu",) * n)


def _lsq(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def _lsq_batches(rng, w_true, n):
    out = []
    for _ in range(n):
        x = rng.standard_normal((64, 16)).astype(np.float32)
        out.append(dict(x=x, y=x @ w_true))
    return out


def test_uncompressed_dp_equals_the_full_batch_step():
    cfg = smoke_config(ARCHS["gemma-2b"])
    bundle = build(cfg, FLAGS, device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 33)
                                        ).astype(np.int32))
    batch = dict(tokens=tok[:, :-1], labels=tok[:, 1:])
    one, _, _, _ = make_train_step(bundle, Mesh(("data", "model"), (1, 1),
                                                ("cpu",)),
                                   POLICIES["fsdp_tp"], opt_cfg)
    p1 = bundle.init(torch.Generator().manual_seed(0))
    p1, o1, m1 = one(p1, adamw.init(p1), batch)
    dp = make_dp_train_step(lambda p, b: bundle.train_loss(p, b)[0],
                            _mesh(2), opt_cfg)
    p2 = bundle.init(torch.Generator().manual_seed(0))
    err = init_error_feedback(p2, num_devices=2)
    p2, o2, err, m2 = dp(p2, adamw.init(p2), err, batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    assert "wire_bytes_saved" not in m2 and int(o2.step) == 1
    # the first moment is (1 - b1) times the clipped gradient: the
    # halves' mean gradient against the full batch's, leaf by leaf
    for k, v in flatten(o1.m).items():
        assert float((flatten(o2.m)[k] - v).abs().max()) <= 1e-4 * (
            float(v.abs().max()) or 1.0), k
    # AdamW's first step moves each param by about lr * sign(g): where g
    # is near zero the halves' mean and the full batch's may differ in
    # sign, which moves the param by at most 2 * lr
    parted = total = 0
    for k, v in flatten(p1).items():
        diff = (flatten(p2)[k] - v).abs().detach()
        assert float(diff.max()) <= 2 * opt_cfg.lr, k
        parted += int((diff > 1e-6).sum())
        total += diff.numel()
    assert parted / total < 1e-3, (parted, total)
    assert all(float(e.abs().max()) == 0 for e in flatten(err).values())


def test_compressed_dp_equals_the_reference_pieces():
    rng = np.random.default_rng(1)
    w_true = rng.standard_normal((16, 4)).astype(np.float32)
    batches = _lsq_batches(rng, w_true, 3)
    cfg = dict(lr=0.1, weight_decay=0.0, clip_norm=None)
    step = make_dp_train_step(_lsq, _mesh(2), AdamWConfig(**cfg),
                              compress_grads=True)
    tp = dict(w=torch.zeros(16, 4))
    to, terr = adamw.init(tp), init_error_feedback(tp, num_devices=2)

    def jloss(p, x, y):
        return jnp.mean((x @ p["w"] - y) ** 2)

    jp = dict(w=jnp.zeros((16, 4)))
    jo, jerr = j_adamw.init(jp), jnp.zeros((2, 16, 4))
    for b in batches:
        tp, to, terr, tm = step(tp, to, terr, {k: torch.from_numpy(v)
                                               for k, v in b.items()})
        deq, new_err = [], []
        for s in range(2):
            half = slice(32 * s, 32 * (s + 1))
            g = jax.grad(jloss)(jp, jnp.asarray(b["x"][half]),
                                jnp.asarray(b["y"][half]))["w"]
            q, sc, ne = j_compress.ef_compress(g, jerr[s])
            deq.append(j_compress.dequantize(q, sc))
            new_err.append(ne)
        jerr = jnp.stack(new_err)
        jp, jo, _ = j_adamw.update(dict(w=(deq[0] + deq[1]) / 2.0), jo, jp,
                                   JAdamWConfig(**cfg))
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(terr["w"].numpy(), np.asarray(jerr),
                                   rtol=1e-5, atol=1e-5)
        assert int(tm["wire_bytes_saved"]) == 16 * 4 * 3


def test_dp_compression_scenario_converges_over_eight_shards():
    """tests/_md_scenarios.py::scenario_dp_compression on eight CPU
    shards, with numpy-drawn data."""
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((16, 4)).astype(np.float32)
    batches = _lsq_batches(rng, w_true, 150)
    results = {}
    for comp in (False, True):
        params = dict(w=torch.zeros(16, 4))
        opt, err = adamw.init(params), init_error_feedback(params,
                                                           num_devices=8)
        step = make_dp_train_step(
            _lsq, _mesh(8), AdamWConfig(lr=0.1, weight_decay=0.0,
                                        clip_norm=None),
            compress_grads=comp)
        first = None
        for b in batches:
            params, opt, err, m = step(params, opt, err,
                                       {k: torch.from_numpy(v)
                                        for k, v in b.items()})
            first = first if first is not None else float(m["loss"])
        results[comp] = (first, float(m["loss"]))
    assert results[False][1] < results[False][0] / 100, results
    assert results[True][1] < results[True][0] / 100, results
    assert results[True][1] < 5 * results[False][1] + 1e-3, results


def test_dp_refuses_a_mesh_without_the_axis_and_wrong_residuals():
    """tests/test_sharding.py::test_dp_shardmap_validates_mesh_and_err_shape."""
    loss = lambda p, b: torch.sum(p["w"] * b["x"])
    with pytest.raises(ValueError, match="data axis"):
        make_dp_train_step(loss, _mesh(1, ("batch",)), AdamWConfig())
    params = dict(w=torch.ones(4))
    err = init_error_feedback(params, num_devices=2)   # the mesh has 1
    step = make_dp_train_step(loss, _mesh(1), AdamWConfig(),
                              compress_grads=True)
    with pytest.raises(ValueError, match="residual"):
        step(params, adamw.init(params), err, dict(x=torch.ones(2, 4)))


def test_sharded_training_waits_for_a10b():
    """The three entry points that refused before A10b now train."""
    cfg = smoke_config(ARCHS["phi4-mini-3.8b"])
    bundle = build(cfg, FLAGS, device="cpu")
    rng = np.random.default_rng(2)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)
                                        ).astype(np.int32))
    batch = dict(tokens=tok, labels=tok)
    got = {}
    for shape in ((1, 1), (1, 2)):
        mesh = Mesh(("data", "model"), shape, ("cpu",) * shape[1])
        step, p_sh, _, _ = make_train_step(bundle, mesh, POLICIES["fsdp_tp"],
                                           AdamWConfig())
        params, opt = shard_state(
            bundle.init(torch.Generator().manual_seed(0)), p_sh, mesh)
        _, _, got[shape] = step(params, opt, batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[1, 2][k]), float(got[1, 1][k]),
                                   rtol=1e-5)
    from repro_torch.dist.serve import ServeMesh
    tp = ServeMesh.tp(2, devices=["cpu", "cpu"]).bind(bundle)
    params = tp.init(torch.Generator().manual_seed(0))
    for t in (params["embed"]["tok"], params["final_norm"]):
        t.requires_grad_(True)
    loss, _ = tp.train_loss(params, batch)
    np.testing.assert_allclose(float(loss.detach()), float(got[1, 1]["loss"]),
                               rtol=1e-5)
    grads = torch.autograd.grad(loss, [params["embed"]["tok"],
                                       params["final_norm"]])
    assert all(float(g.abs().sum()) > 0 for g in grads)
    assert launch_train.main(["--arch", "gemma-2b", "--smoke", "--device",
                              "cpu", "--mesh-model", "2", "--devices",
                              "cpu,cpu", "--steps", "2", "--seq", "16",
                              "--batch", "2"]) == 0
