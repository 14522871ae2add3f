"""BENCHMARK.json and the files it names: every name and unit keeps the
rules, every cell finds its configuration, mix, mode and limits (one for
each of the mode's checks), every metric its reader, and each cell
reports setup_s, another end-to-end metric and a per-layer one."""

import importlib.util
import json
import os

import pytest

from benchmark import spec

ROOT = spec.ROOT


def test_benchmark_json_and_its_files():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
    for w in b["workloads"]:
        _, c, cfg, mix = spec.cell(b, w["name"])
        lim = spec.limits(w["name"], spec.mode(mix).CHECKS)
        assert lim
        e2e = {m["name"] for m in spec.metrics_of(b, w["name"],
                                                  "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(b, w["name"], "per_layer")
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        layers.setdefault(m["layer"], m["layer"])


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(kind):
    b = spec.benchmark()
    for m in b[kind]:
        path = os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py")
        s = importlib.util.spec_from_file_location("x", path)
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
        assert mod.UNIT == m["unit"]
        if kind == "per_layer":
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
            if m["unit"] == "%":
                # nothing to read: nothing returned, never 0
                ctx = {"trace": None, "traced": False, "counters": {}}
                assert mod.read(ctx) is None


@pytest.mark.parametrize("name,ok", [
    ("ecoli-pacbio.map", True), ("_x", True), ("a" * 64, True),
    ("a" * 65, False), ("a b", False), ("a/b", False), ("-a", False),
    ("a,b", False), ("", False), ("µs", False)])
def test_names(name, ok):
    if ok:
        assert spec.check_name(name, "t") == name
    else:
        with pytest.raises(spec.SpecError):
            spec.check_name(name, "t")


@pytest.mark.parametrize("unit,ok", [
    ("Mbases/s", True), ("%", True), ("ms/Mbase", True),
    ("problems/launch", True), ("tokens per s", False), ("a" * 17, False),
    ("us", True), ("µs", False)])
def test_units(unit, ok):
    if ok:
        assert spec.check_unit(unit, "t") == unit
    else:
        with pytest.raises(spec.SpecError):
            spec.check_unit(unit, "t")
