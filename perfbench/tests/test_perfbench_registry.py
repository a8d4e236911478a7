"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, output check and per-layer reader is found by its name, an
unknown name is refused, and the file keeps its format."""
import json
import re

import pytest

from perfbench import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads(cell):
    c = registry.load_cell(cell)
    assert c.chips == 1
    assert c.config["name"] in {x["name"] for x in BENCH["configs"]}
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    # each per-layer metric's cells report the end-to-end metric it moves
    for m in c.per_layer:
        assert m["moves"] in names
    assert set(registry.readers(c.per_layer)) == {m["name"]
                                                  for m in c.per_layer}


@pytest.mark.parametrize("kind,name", [
    ("workload", "no-such.cell"), ("config", "no-such-model"),
    ("traffic", "no-such-mix"), ("metric", "no.such.metric"),
    ("workload", "../etc"), ("metric", "a/b")])
def test_unknown_names_refused(kind, name):
    find = {"workload": registry.load_cell,
            "config": lambda n: registry.config_file(BENCH, n),
            "traffic": registry.traffic_file,
            "metric": registry.metric_reader}[kind]
    with pytest.raises(KeyError):
        find(name)


def test_benchmark_file_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert not set(c["reduced"]) & {"hidden_size", "intermediate_size",
                                        "head_dim", "num_experts_per_tok"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\t" not in w["why"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_config_matches_the_port(cfg):
    from repro_torch.configs import ARCHS
    from perfbench.harness import check_model
    c = registry.config_file(BENCH, cfg)
    check_model(ARCHS[c["arch"]], c["model"], c["dtypes"])
    entry = next(x for x in BENCH["configs"] if x["name"] == cfg)
    assert entry["reduced"] == c["reduced"]
    for key in c["reduced"]:
        assert key in c["published_values_changed"]
