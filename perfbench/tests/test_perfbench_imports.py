"""What the runs import: ``perfbench.run``, the harness and every
reference module load no top-level ``jax``, ``jaxlib``, ``flax`` or
``repro`` (whole names: ``repro_torch`` is not ``repro``) and nothing of
``benchmarks``; the references load nothing of ``repro_torch`` either."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
REFS = sorted(p.stem for p in (ROOT / "perfbench" / "reference").glob("*.py")
              if p.stem != "__init__")


def loaded(stmt: str) -> set:
    code = (f"import sys, json; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'src')!r}]; {stmt}; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=env, cwd=str(ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


BAD = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


@pytest.mark.parametrize("stmt", [
    "import perfbench.run",
    "import perfbench.harness, perfbench.knee, perfbench.calibrate",
    "import repro_torch.serve, repro_torch.models, repro_torch.kernels.ops",
])
def test_runs_load_no_jax(stmt):
    top = loaded(stmt)
    assert not top & BAD, top & BAD


@pytest.mark.parametrize("mod", REFS)
def test_references_load_nothing_of_the_program(mod):
    top = loaded(f"import perfbench.reference.{mod}")
    assert not top & (BAD | {"repro_torch"}), top


def test_run_refuses_without_a_card(tmp_path):
    if subprocess.run([sys.executable, "-c", "import torch, sys; "
                       "sys.exit(torch.cuda.is_available())"]).returncode:
        pytest.skip("a card is visible")
    out = subprocess.run([sys.executable, "-m", "perfbench.run",
                          "--workload", "phi4-mini.reason-batch",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(ROOT))
    assert out.returncode != 0 and out.stdout.strip() == ""
