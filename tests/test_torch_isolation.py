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
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build
from repro_torch.serve import ServeEngine

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


def test_launcher_serves_on_an_explicit_cpu(capsys):
    assert launch_serve.main(["--arch", "gemma-2b", "--smoke", "--device",
                              "cpu", "--requests", "3", "--batch", "2",
                              "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "12 tokens" in out and "on cpu" in out


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
