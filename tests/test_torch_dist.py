"""The port's distribution layer, held against the reference on the CPU.

- rule tables and specs: the port's counterpart of every case of
  ``tests/test_sharding.py`` (``spec_for``'s fallbacks, the policy
  registry, engines, ``param_shardings`` trees, batch shardings) agrees
  with ``repro.dist.sharding`` on the same inputs (the reference needs no
  devices for these: its mesh is anything with a ``.shape``);
- logical axes: for every architecture at smoke width the port's specs
  tree (``ModelBundle.param_specs``) equals the reference's
  ``abstract_params()[1]``;
- meshes, the shard-order collectives, ``ServeMesh``'s param and pool
  slicing, its refusals and ``validate``'s messages (the reference's),
  what the MoE, recurrent and encoder-decoder stacks do at TP=2;
- the launcher's ``--tp``/``--dp`` at smoke width on CPU devices against
  the reference launcher's counters, and its refusal of a device group it
  does not have;
- the ``dist_serve`` sweep at ``fast`` over ``["cpu", "cpu"]``: the
  reference's row names in its order, and its gates.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.dist as JD
from repro.configs import ARCHS as J_ARCHS
from repro.configs import override as j_override
from repro.configs import smoke_config as j_smoke
from repro.models import build as j_build
import repro_torch.dist as TD
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import override as t_override
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.dist import ServeMesh
from repro_torch.dist import serve as dserve
from repro_torch.dist import tp as tp_mod
from repro_torch.launch.mesh import Mesh, make_test_mesh
from repro_torch.models import build as t_build
from repro_torch.serve import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


class FakeMesh:
    shape = {"data": 4, "model": 2}


class FakeMultiPodMesh:
    shape = {"pod": 2, "data": 4, "model": 2}


class FakeTPMesh:
    def __init__(self, tp):
        self.shape = {"model": tp}


# ---------------------------------------------------------------------------
# rule tables and specs: every case of tests/test_sharding.py
# ---------------------------------------------------------------------------

SPEC_CASES = {
    "scalar": ((), (), "PARAM_RULES_FSDP", FakeMesh),
    "unsharded-vector": ((64,), ("embed",), "PARAM_RULES_FSDP", FakeMesh),
    "name-mismatch": ((8, 8), ("layers", "state"), "PARAM_RULES_FSDP",
                      FakeMesh),
    "none-axis": ((16, 32), (None, "ff"), "PARAM_RULES_FSDP", FakeMesh),
    "missing-mesh-axis": ((64,), ("embed",), (("embed", "zz_missing"),),
                          FakeMesh),
    "divisibility": ((6, 6), ("embed", "ff"), "PARAM_RULES_FSDP", FakeMesh),
    "axis-once": ((8, 8), ("heads", "ff"), "PARAM_RULES_FSDP", FakeMesh),
    "tuple-rule": ((16, 32), ("batch", None),
                   (("batch", ("pod", "data")),), FakeMultiPodMesh),
    "tuple-partial": ((4, 8), ("batch", None),
                      (("batch", ("pod", "data")),), FakeMultiPodMesh),
    "sp-residual": ((8, 32, 64), ("batch", "seq", "embed"), "ACT_RULES_SP",
                    FakeMesh),
    "sp-heads": ((8, 32, 4, 16), ("batch", "seq", "heads", None),
                 "ACT_RULES_SP", FakeMesh),
    "tp-vocab": ((256, 64), ("vocab", "embed"), "PARAM_RULES_TP", FakeMesh),
    "tp-odd-ff": ((64, 6), ("embed", "ff"), "PARAM_RULES_TP",
                  FakeMultiPodMesh),
    "act-tp": ((8, 12, 4, 16), ("batch", None, "heads", None),
               "ACT_RULES_TP", FakeMultiPodMesh),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_for_equals_reference(case):
    shape, axes, rules, mesh = SPEC_CASES[case]
    jrules = getattr(JD, rules) if isinstance(rules, str) else rules
    trules = getattr(TD, rules) if isinstance(rules, str) else rules
    want = JD.spec_for(shape, axes, jrules, mesh())
    got = TD.spec_for(shape, axes, trules, mesh())
    assert isinstance(got, tuple) and got == tuple(want)


def test_rule_tables_equal_reference():
    for name in ("PARAM_RULES_FSDP", "PARAM_RULES_TP", "ACT_RULES_TP",
                 "ACT_RULES_SP", "BATCH_RULES"):
        assert getattr(TD, name) == getattr(JD, name), name


def test_policies_equal_reference():
    assert set(TD.POLICIES) == set(JD.POLICIES) >= {"dp", "tp", "fsdp_tp",
                                                     "fsdp_tp_sp"}
    for name, jp in JD.POLICIES.items():
        tp = TD.POLICIES[name]
        assert (tp.name, tp.param_rules, tp.act_rules, tp.batch_rules,
                tp.description) == (jp.name, jp.param_rules, jp.act_rules,
                                    jp.batch_rules, jp.description)
        for mesh in (FakeMesh(), FakeMultiPodMesh(), FakeTPMesh(2)):
            assert tp.engines(mesh) == jp.engines(mesh)
            assert tp.param_engines(mesh) == jp.param_engines(mesh)
            assert tp.data_engines(mesh) == jp.data_engines(mesh)
    # the reference test's numbers
    assert TD.POLICIES["fsdp_tp"].engines(FakeMesh()) == 8
    assert TD.POLICIES["dp"].param_engines(FakeMesh()) == 1


def test_batch_shardings_equal_reference():
    for mesh in (FakeMesh(), FakeMultiPodMesh()):
        for shape in ((16, 32), (4, 8), (3,), ()):
            # the reference's batch_sharding wraps this spec in a
            # NamedSharding, which needs a jax mesh of that shape
            axes = ("batch",) + (None,) * (len(shape) - 1) if shape else ()
            for name, jp in JD.POLICIES.items():
                got = TD.POLICIES[name].batch_sharding(mesh,
                                                       torch.empty(shape))
                assert got == tuple(JD.spec_for(shape, axes, jp.batch_rules,
                                                mesh))
    batch = dict(tokens=torch.empty(16, 8), extra=dict(x=torch.empty(4)))
    got = TD.POLICIES["tp"].batch_shardings(FakeMultiPodMesh(), batch)
    assert got == dict(tokens=(("pod", "data"), None), extra=dict(x=("pod",)))


def test_param_shardings_tree_equals_reference():
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    abs_params = dict(
        emb=jax.ShapeDtypeStruct((256, 64), jnp.float32),
        blk=dict(w=jax.ShapeDtypeStruct((2, 64, 128), jnp.float32)))
    specs = dict(emb=("vocab", "embed"), blk=dict(w=("layers", "embed", "ff")))
    want = JD.param_shardings(jmesh, abs_params, specs, JD.PARAM_RULES_FSDP)
    tmesh = Mesh(("data", "model"), (1, 1), (CPU,))
    params = dict(emb=torch.empty(256, 64, device="meta"),
                  blk=dict(w=torch.empty(2, 64, 128, device="meta")))
    got = TD.param_shardings(tmesh, params, specs, TD.PARAM_RULES_FSDP)
    assert got == dict(emb=tuple(want["emb"].spec),
                       blk=dict(w=tuple(want["blk"]["w"].spec)))
    assert got == dict(emb=("model", "data"),
                       blk=dict(w=(None, "data", "model")))


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_param_specs_equal_reference(arch):
    want = j_build(j_smoke(J_ARCHS[arch])).abstract_params()[1]
    got = t_build(t_smoke(T_ARCHS[arch]), device="cpu").param_specs()
    assert got == want


# ---------------------------------------------------------------------------
# meshes and collectives
# ---------------------------------------------------------------------------

def test_mesh_shapes_and_lines():
    m = make_test_mesh(4, 2, devices=["cpu"] * 8)
    assert m.shape == {"data": 4, "model": 2} and len(m.devices) == 8
    assert m.devices_along("model") == [CPU, CPU]
    assert len(m.devices_along("data")) == 4
    with pytest.raises(ValueError, match=r"\(4, 2\) mesh needs 8 devices, have 3"):
        make_test_mesh(4, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="needs 2 devices, got 1"):
        Mesh(("model",), (2,), (CPU,))


def test_collectives_run_in_shard_order():
    a, b, c = (torch.tensor([1e8, 1.0]), torch.tensor([-1e8, 1.0]),
               torch.tensor([1.0, 1e-8]))
    # float32: (a + b) + c != a + (b + c), so the order shows
    assert torch.equal(dserve.reduce_sum([a, b, c], CPU), (a + b) + c)
    g = tp_mod.DeviceGroup([CPU] * 3)
    tp_mod.reset_copies()
    assert torch.equal(tp_mod.reduce_sum(g, [a, b, c], "sum"), (a + b) + c)
    assert torch.equal(tp_mod.reduce_max(g, [a, b, c], "max"),
                       torch.tensor([1e8, 1.0]))
    # each part from another shard counted: what distinct cards move
    assert tp_mod.COPIES == {"sum": 16, "max": 16}
    x = torch.arange(12.0).reshape(3, 4)
    parts = dserve.split(x, 1, [CPU, CPU])
    assert [p.shape for p in parts] == [(3, 2), (3, 2)]
    assert all(p.is_contiguous() for p in parts)
    assert torch.equal(dserve.gather(parts, 1, CPU), x)
    copies = dserve.broadcast(dict(t=x), [CPU, CPU])
    assert copies[0]["t"] is x and copies[1]["t"] is x   # one device: shared
    assert dserve.shard_dim((None, ("pod", "model")), "model") == 1
    assert dserve.shard_dim((None, "data"), "model") is None


# ---------------------------------------------------------------------------
# ServeMesh
# ---------------------------------------------------------------------------

def _phi4():
    cfg = t_smoke(T_ARCHS["phi4-mini-3.8b"])
    bundle = t_build(cfg, device="cpu")
    return cfg, bundle, bundle.init(torch.Generator().manual_seed(0))


def test_serve_mesh_shards_params_by_the_tp_policy():
    cfg, bundle, params = _phi4()
    sm = ServeMesh.tp(2, devices=["cpu", "cpu"])
    assert sm.tp_degree == 2 and sm.home == CPU
    shards = sm.shard_params(bundle, params)
    specs = sm.param_shardings(bundle, params)
    assert specs["blocks"]["p0"]["attn"]["wq"] == (None, None, "model")
    assert specs["blocks"]["p0"]["attn"]["wo"] == (None, "model", None)
    assert specs["blocks"]["p0"]["mlp"]["w_down"] == (None, "model", None)
    assert specs["embed"]["tok"] == ("model", None)
    assert specs["final_norm"] == (None,)
    for path, dim in ((("blocks", "p0", "attn", "wq"), 2),
                      (("blocks", "p0", "attn", "wo"), 1),
                      (("blocks", "p0", "mlp", "w_gate"), 2),
                      (("embed", "tok"), 0)):
        def at(t):
            for k in path:
                t = t[k]
            return t
        whole = at(params)
        parts = [at(s) for s in shards]
        assert all(p.shape[dim] * 2 == whole.shape[dim] for p in parts)
        assert torch.equal(torch.cat(parts, dim), whole)
    # replicated leaves: the caller's tensor on its own device
    assert all(s["final_norm"] is params["final_norm"] for s in shards)
    # TP=1 gives the tree itself
    one = ServeMesh.tp(1, devices=["cpu"]).shard_params(bundle, params)
    assert one["embed"]["tok"] is params["embed"]["tok"]


def test_serve_mesh_splits_pools_on_kv_heads():
    cfg = t_override(t_smoke(T_ARCHS["gemma-2b"]), num_kv_heads=2)
    bundle = t_build(cfg, device="cpu")
    from repro_torch.models import RuntimeFlags
    b8 = t_build(cfg, RuntimeFlags(kv_dtype="int8"), device="cpu")
    sm = ServeMesh.tp(2, devices=["cpu", "cpu"])
    cache = b8.init_paged_cache(5, 8, batch=2)
    specs = sm.paged_cache_shardings(cache)
    layer = specs["blocks"]["p0"]
    assert layer["k_pages"] == (None, None, None, "model", None)
    assert layer["k_scale"] == (None, None, None)
    assert sm.page_swap_shardings(cache) == specs
    shards = sm.shard_paged_cache(cache)
    for s in shards:
        assert s["blocks"]["p0"]["k_pages"].shape[-2] == 1
        assert s["blocks"]["p0"]["k_scale"] is cache["blocks"]["p0"][
            "k_scale"]
    dense = sm.shard_dense_cache(bundle.init_cache(2, 16))
    assert dense[0]["blocks"]["p0"]["k"].shape[-2] == 1


def test_serve_mesh_refusals_equal_reference():
    from repro.dist import ServeMesh as JServeMesh

    # too few devices: the reference's message at the same counts
    with pytest.raises(ValueError) as want:
        JServeMesh.tp(2, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        ServeMesh.tp(2, devices=["cpu"])
    assert str(got.value) == str(want.value) == "tp=2 needs 2 devices, have 1"
    # heads that do not divide: validate's messages
    for arch, tp in (("phi4-mini-3.8b", 3), ("gemma-2b", 2),
                     ("gemma2-27b", 4)):
        with pytest.raises(ValueError) as want:
            JServeMesh(mesh=FakeTPMesh(tp)).validate(j_smoke(J_ARCHS[arch]))
        with pytest.raises(ValueError) as got:
            ServeMesh.tp(tp, devices=["cpu"] * tp).validate(
                t_smoke(T_ARCHS[arch]))
        assert str(got.value) == str(want.value)
    # the dense backend: the reference engine's refusal
    bundle = t_build(t_smoke(T_ARCHS["phi4-mini-3.8b"]), device="cpu")
    with pytest.raises(ValueError, match="cache_backend='paged' is required"):
        ServeEngine(bundle, {}, 2, 32, cache_backend="dense",
                    dist=ServeMesh.tp(2, devices=["cpu", "cpu"]))
    with pytest.raises(ValueError, match="first device is cpu"):
        ServeEngine(bundle, {}, 2, 32, device="meta",
                    dist=ServeMesh.tp(2, devices=["cpu", "cpu"]))


A9B = {"granite-moe-3b-a800m": {}, "mamba2-130m": {},
       "recurrentgemma-9b": dict(num_kv_heads=2), "seamless-m4t-medium": {},
       "grok-1-314b": {}}


@pytest.mark.parametrize("arch", sorted(A9B))
def test_moe_recurrent_and_encdec_stacks_wait_for_a9b(arch):
    """What each of these stacks does at TP=2, as the reference does: the
    decoders validate and build an engine (recurrentgemma-9b at its native
    one kv head still fails the heads check, word for word);
    seamless-m4t-medium validates, and the engine refuses it, since a
    mesh needs the paged backend."""
    from repro.dist import ServeMesh as JServeMesh
    cfg = t_override(t_smoke(T_ARCHS[arch]), **A9B[arch])
    sm = ServeMesh.tp(2, devices=["cpu", "cpu"])
    sm.validate(cfg)
    JServeMesh(mesh=FakeTPMesh(2)).validate(
        j_override(j_smoke(J_ARCHS[arch]), **A9B[arch]))
    bundle = t_build(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    if cfg.enc_dec:
        with pytest.raises(ValueError,
                           match="cache_backend='paged' is required"):
            ServeEngine(bundle, params, 2, 32, dist=sm)
    else:
        eng = ServeEngine(bundle, params, 2, 32, dist=sm)
        assert eng.tp == 2 and len(eng.params) == 2
    if arch == "recurrentgemma-9b":
        native = t_smoke(T_ARCHS[arch])
        with pytest.raises(ValueError) as want:
            JServeMesh(mesh=FakeTPMesh(2)).validate(
                j_smoke(J_ARCHS[arch]))
        with pytest.raises(ValueError) as got:
            sm.validate(native)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "phi4-mini-3.8b", "--smoke", "--requests", "6",
          "--batch", "2", "--max-new", "4", "--max-len", "64"]


def _counters(text):
    line = next(ln for ln in text.splitlines() if "replica(s)" in ln)
    return dict(re.findall(r"(prefills|decode_steps|decode_dispatches)=(\d+)",
                           line)), line


@pytest.mark.parametrize("layout", [["--tp", "2"], ["--dp", "2"],
                                    ["--tp", "2", "--kv-int8"]])
def test_launcher_tp_and_dp_on_cpu_devices(layout, capsys):
    """``--tp 2`` / a colocated ``--dp 2`` over an explicit ``cpu,cpu``
    group: the reference launcher's pool summary, the same 24 tokens and,
    at TP=2, the reference launcher's single-device counters (one engine
    drained the same way)."""
    from repro.launch.serve import main as j_main
    from repro_torch.launch.serve import main as t_main

    kv = ["--kv-int8"] if "--kv-int8" in layout else []
    assert j_main(LAUNCH + kv) == 0
    want, _ = _counters(capsys.readouterr().out)
    assert t_main(LAUNCH + layout + ["--devices", "cpu,cpu"]) == 0
    out = capsys.readouterr().out
    got, line = _counters(out)
    assert line.startswith("24 tokens in ")
    if "--tp" in layout:
        assert "across 1 replica(s) x tp=2" in line and got == want
        assert "per-replica requests: r0=6" in out
    else:
        assert "across 2 replica(s) x tp=1" in line
        assert got["prefills"] == want["prefills"]
        assert "per-replica requests: r0=3, r1=3" in out


def test_launcher_refuses_a_group_it_does_not_have():
    from repro.launch.serve import device_groups as j_groups
    from repro_torch.launch.serve import device_groups, main as t_main

    with pytest.raises(ValueError) as want:
        j_groups(2, 1, jax.devices()[:1])
    with pytest.raises(SystemExit, match=re.escape(str(want.value))):
        t_main(LAUNCH + ["--device", "cpu", "--tp", "2"])
    assert device_groups(2, 2, ["cpu"] * 4) == [["cpu", "cpu"]] * 2
    with pytest.raises(ValueError, match="must be >= 1"):
        device_groups(0, 1, ["cpu"])


# ---------------------------------------------------------------------------
# the dist_serve sweep
# ---------------------------------------------------------------------------

def _reference_rows():
    """The reference sweep's row names in the order its source emits
    them: the literal names, then the two per-axis scaling rows of its
    closing loop."""
    src = (ROOT / "src/repro/bench/sweeps/dist_serve.py").read_text()
    names = re.findall(r'"(dist_serve_\w+)"', src)
    assert 'f"dist_serve_{name}_scaling"' in src
    return names + ["dist_serve_tp_scaling", "dist_serve_dp_scaling"]


def test_dist_serve_rows_and_gates_over_cpu_devices():
    from repro_torch.bench import run_sweeps

    run = run_sweeps(names=["dist_serve"], fast=True, echo=False,
                     device="cpu", devices=["cpu", "cpu"])
    assert not run.failures, run.failures
    names = [r.name for r in run.results]
    assert names == _reference_rows() == [
        "dist_serve_tp1", "dist_serve_tp2", "dist_serve_tp2_token_parity",
        "dist_serve_per_shard_live_bytes_ratio", "dist_serve_dp2",
        "dist_serve_dp2_token_parity", "dist_serve_tp_scaling",
        "dist_serve_dp_scaling"]
    rows = {r.name: r for r in run.results}
    assert rows["dist_serve_tp2_token_parity"].gbps_measured == 1.0
    assert rows["dist_serve_dp2_token_parity"].gbps_measured == 1.0
    ratio = rows["dist_serve_per_shard_live_bytes_ratio"]
    assert ratio.gbps_measured == 2.0 and ratio.extras["deterministic"]
    assert rows["dist_serve_tp1"].extras["tokens_out"] == 32
    # one device: nothing to shard over, as the reference on one device
    alone = run_sweeps(names=["dist_serve"], fast=True, echo=False,
                       device="cpu")
    assert not alone.failures and alone.results == []
