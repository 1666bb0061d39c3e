"""Every entry of ``BENCHMARK.json`` resolves through the harness's lookup
by name, and the file keeps to the benchmark's contract."""

from __future__ import annotations

import json
import re

import pytest

from portbench import spec
from portbench.drivers import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_every_entry_resolves(bench):
    for c in bench["configs"]:
        cfg = spec.config(bench, c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        common.model_config(cfg)
        common.train_config(cfg)
    for w in bench["workloads"]:
        traffic = spec.traffic(w["traffic"])
        drv = spec.driver(traffic["kind"])
        assert callable(drv.setup) and callable(drv.control) and callable(drv.flops)
        assert spec.limits(w["name"])
        e2e = [m["name"] for m in spec.metrics_of(bench, w["name"], "end_to_end")]
        layer = spec.metrics_of(bench, w["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]).read)


def test_contract_shape(bench):
    assert set(bench) == KEYS
    assert bench["paths"] == ["portbench"] and 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for x in bench["configs"] + bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for n in names + metrics:
        assert NAME.match(n), n
    assert len(set(metrics)) == len(metrics)
    assert len({x["name"] for x in bench["configs"]}) == len(bench["configs"])
    assert len({x["name"] for x in bench["workloads"]}) == len(bench["workloads"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and len(c["why"]) <= 200
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200 and "\n" not in w["why"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and len(m["layer"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            spec.cell(bench, w)
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_missing_name_is_refused(bench):
    with pytest.raises(KeyError):
        spec.cell(bench, "no-such-cell")
    with pytest.raises(KeyError):
        spec.reader("no_such_metric")
