"""Find a cell, its configuration, its traffic, its output check and its
per-layer metric readers by the names ``BENCHMARK.json`` gives them.

Each is a file of its own under this directory: ``configs/<config>.json``
(the configuration's ``file``), ``traffic/<traffic>.json``,
``checks/<cell>.json`` and ``metrics/<metric>.py``.  An unknown name is
an error, never a default.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

from perfbench.loadgen import Spec

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME_OK = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
              "0123456789_.-")


def _name(kind: str, name: str) -> str:
    if not name or len(name) > 64 or not set(name) <= NAME_OK \
            or name[0] in ".-":
        raise KeyError(f"bad {kind} name {name!r}")
    return name


def benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file
    traffic: Spec
    check: dict           # the output check's limits
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def config_file(bench: dict, name: str, root: Path = ROOT) -> dict:
    _name("config", name)
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"unknown config {name!r}")


def traffic_file(name: str) -> dict:
    path = HERE / "traffic" / f"{_name('traffic', name)}.json"
    if not path.is_file():
        raise KeyError(f"unknown traffic {name!r} (no {path.name})")
    return json.loads(path.read_text())


def check_file(cell: str) -> dict:
    path = HERE / "checks" / f"{_name('cell', cell)}.json"
    if not path.is_file():
        raise KeyError(f"no output check for cell {cell!r} ({path.name})")
    return json.loads(path.read_text())


def metric_reader(name: str) -> Callable:
    """The ``read(records)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{_name('metric', name)}.py"
    if not path.is_file():
        raise KeyError(f"unknown metric {name!r} (no reader {path.name})")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    _name("workload", name)
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"unknown workload {name!r}; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]),
                config=config_file(bench, w["config"], root),
                traffic=Spec.from_dict(traffic_file(w["traffic"])),
                check=check_file(name), end_to_end=e2e, per_layer=per_layer)


def readers(metrics: List[dict]) -> Dict[str, Callable]:
    return {m["name"]: metric_reader(m["name"]) for m in metrics}
