"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller names the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import ARCHS, ShapeCell, smoke_config
from repro_torch.dist import POLICIES
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh
from repro_torch.models import ModelBundle, build
from repro_torch.optim import AdamWConfig
from repro_torch.serve import ServeEngine
from repro_torch.train import TrainConfig, Trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"


def test_importing_every_module_loads_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('modules', sum(n.startswith('repro_torch') for n in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15


@pytest.mark.parametrize("module", ["repro_torch.models.moe",
                                    "repro_torch.models.encdec",
                                    "repro_torch.dist.sharding",
                                    "repro_torch.dist.serve",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.bench.sweeps.dist_serve",
                                    "repro_torch.tree",
                                    "repro_torch.optim",
                                    "repro_torch.optim.adamw",
                                    "repro_torch.optim.schedule",
                                    "repro_torch.optim.compress",
                                    "repro_torch.data.pipeline",
                                    "repro_torch.dist.steps",
                                    "repro_torch.dist.dp_shardmap",
                                    "repro_torch.train",
                                    "repro_torch.train.checkpoint",
                                    "repro_torch.train.fault",
                                    "repro_torch.train.loop",
                                    "repro_torch.launch.train",
                                    "repro_torch.dist.fsdp",
                                    "repro_torch.models.sharded",
                                    "repro_torch.core.roofline",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.bench.sweeps.roofline",
                                    "repro_torch.dist.tp"])
def test_new_module_alone_loads_neither_jax_nor_reference(module):
    """Each module of the MoE and encoder-decoder slice, of the
    distribution slice, of the training slice, of the sharded
    training and dry-run slice and of the tensor-parallel families'
    copies, imported by itself in a fresh interpreter."""
    code = (f"import sys, {module}\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    cfg = smoke_config(ARCHS["gemma-2b"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build(cfg)
    bundle = build(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ServeEngine(bundle, params, 2, 32)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch_serve.main(["--arch", "gemma-2b", "--smoke"])


def test_training_raises_without_a_card(no_card):
    cfg = smoke_config(ARCHS["gemma-2b"])
    on_card = ModelBundle(cfg=cfg, device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Trainer(on_card, ShapeCell("c", "train", 32, 4),
                Mesh(("data", "model"), (1, 1), ("cuda",)),
                POLICIES["fsdp_tp"], AdamWConfig(), TrainConfig(steps=1))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch_train.main(["--arch", "gemma-2b", "--smoke", "--steps", "1"])
    with pytest.raises(SystemExit, match="needs 2 devices, have 0"):
        launch_train.main(["--arch", "gemma-2b", "--smoke", "--steps", "1",
                           "--mesh-model", "2"])


def test_launcher_serves_on_an_explicit_cpu(capsys):
    assert launch_serve.main(["--arch", "gemma-2b", "--smoke", "--device",
                              "cpu", "--requests", "3", "--batch", "2",
                              "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "12 tokens" in out and "on cpu" in out


def test_launcher_serves_a_dense_cache_on_an_explicit_cpu(capsys):
    assert launch_serve.main(["--arch", "phi4-mini-3.8b", "--smoke",
                              "--cache", "dense", "--device", "cpu",
                              "--requests", "3", "--batch", "2",
                              "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "12 tokens" in out and "on cpu" in out and "dense cache" in out
    assert "prefill_chunks=0" in out


def test_engine_refuses_a_bundle_on_another_device():
    cfg = smoke_config(ARCHS["gemma-2b"])
    bundle = build(cfg, device="cpu")
    with pytest.raises(ValueError, match="bundle runs on"):
        ServeEngine(bundle, {}, 2, 32, device="meta")


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(lone)], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
