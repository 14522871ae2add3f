"""The benchmark's data: BENCHMARK.json at the checkout's root, and the
files that it names by name (configs/<config>.json, traffic/<mix>.json,
limits/<cell>.json, metrics/<metric>.py, kernels.json, peaks.json), and
the traffic mode that a mix names by its "mode" key (modes/<mode>.py).

A later change adds a cell, a mix or a metric by adding such files and
entries; nothing here names one. Names and units are checked before
anything else runs.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MODES = os.path.join(HERE, "modes")

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class SpecError(ValueError):
    """BENCHMARK.json or a file it names breaks the benchmark's rules."""


def check_name(name, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise SpecError(f"{what} {name!r}: a name is 1-64 letters, digits, "
                        "'_', '.', '-', starting with a letter, digit or '_'")
    return name


def check_unit(unit, what: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise SpecError(f"{what}: unit {unit!r} is 1-16 of letters, digits, "
                        "'_', '/', '%', '.', '-'")
    return unit


def load_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def benchmark(path: str | None = None) -> dict:
    """BENCHMARK.json, with every name and unit checked."""
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    for c in b["configs"]:
        check_name(c["name"], "config")
        for k in c["reduced"]:
            check_name(k, f"config {c['name']} reduced key")
    for w in b["workloads"]:
        check_name(w["name"], "workload")
        check_name(w["config"], f"workload {w['name']} config")
        check_name(w["traffic"], f"workload {w['name']} traffic")
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            check_name(m["name"], kind)
            check_unit(m["unit"], f"metric {m['name']}")
            if m["better"] not in ("lower", "higher"):
                raise SpecError(f"metric {m['name']}: better is lower or "
                                "higher")
    return b


def metrics_of(b: dict, cell: str, kind: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics that `cell`
    reports: those whose `workloads` list it, or, without the key, every
    per-layer metric whose `moves` the cell reports, every end-to-end one."""
    e2e = [m for m in b["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in b["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def cell(b: dict, name: str) -> tuple[dict, dict, dict, dict]:
    """(workload entry, config entry, config file, traffic file)."""
    check_name(name, "workload")
    w = next((w for w in b["workloads"] if w["name"] == name), None)
    if w is None:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in b["configs"] if c["name"] == w["config"])
    return w, c, load_json(c["file"]), load_json(
        os.path.join("benchmark", "traffic", w["traffic"] + ".json"))


def mode(mix: dict):
    """The module modes/<mode>.py that the mix's "mode" key names: its
    `CHECKS` and its `Mode` (modes/__init__.py). Loaded before any
    set-up, so that a mode with no file stops a run first."""
    name = check_name(mix.get("mode"), "traffic mode")
    path = os.path.join(MODES, name + ".py")
    if not os.path.isfile(path):
        raise SpecError(f"traffic mode {name!r} has no file {path}")
    s = importlib.util.spec_from_file_location(
        "benchmark_mode_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    if not hasattr(mod, "Mode") or not hasattr(mod, "CHECKS"):
        raise SpecError(f"traffic mode {name!r}: {path} lacks Mode or "
                        "CHECKS")
    return mod


def limits(name: str, checks=None) -> dict:
    """The cell's limits: {check: limit}; with `checks`, the names that
    the cell's mode compares, which the limits' keys have to equal."""
    lim = load_json(os.path.join("benchmark", "limits",
                                 name + ".json"))["limits"]
    if checks is not None and set(lim) != set(checks):
        raise SpecError(f"limits/{name}.json: limits {sorted(lim)} against "
                        f"the mode's checks {sorted(checks)}")
    return lim
