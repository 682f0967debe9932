"""BENCHMARK.json and the files it names, found by name: a configuration is
`configs/<config>.json`, a traffic mix `traffic/<mix>.json`, a per-layer
metric's reader `metrics/<metric>.py`, a FLOP table `flops/<config>.json`
and a cell's correctness limits `limits/<workload>.json`, all under the
benchmark's folder. The name and unit rules are checked here too."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Any, Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return load_json(MANIFEST)


def workload(man: Dict, name: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> Dict:
    return load_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def traffic(name: str) -> Dict:
    return load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def flop_table(config_name: str) -> Dict:
    return load_json(os.path.join(BENCH_DIR, "flops", f"{config_name}.json"))


def limits(workload_name: str) -> Dict:
    return load_json(os.path.join(BENCH_DIR, "limits", f"{workload_name}.json"))


def reader(metric: str) -> Callable:
    """`read(run)` of metrics/<metric>.py, loaded by path (a metric's name
    may hold dots)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(man: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of `cell` reports: with trace the per-layer ones
    that list it (or list no cells and move an end-to-end metric the cell
    reports), else the end-to-end ones that list it or list no cells."""
    e2e = [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def check(man: Dict) -> List[str]:
    """The manifest's breaches of the name, unit, key and reference rules
    (an empty list when it keeps them)."""
    errs: List[str] = []
    if set(man) != TOP_KEYS:
        errs.append(f"top-level keys {sorted(man)}")
    for group, keys in (("configs", CONFIG_KEYS), ("workloads", WORKLOAD_KEYS),
                        ("end_to_end", E2E_KEYS), ("per_layer", LAYER_KEYS)):
        names = [e.get("name", "") for e in man.get(group, [])]
        if len(set(names)) != len(names):
            errs.append(f"{group}: names repeat")
        for e in man.get(group, []):
            extra = set(e) - keys - ({"workloads"} if group in ("end_to_end", "per_layer") else set())
            if extra or not keys <= set(e):
                errs.append(f"{group} {e.get('name')}: keys {sorted(e)}")
            if not NAME_RE.match(e.get("name", "")):
                errs.append(f"{group}: bad name {e.get('name')!r}")
            if "unit" in e and not UNIT_RE.match(e["unit"]):
                errs.append(f"{e['name']}: bad unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                errs.append(f"{e['name']}: better {e['better']!r}")
            for text in ("why", "layer", "source"):
                if text in e and not (1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]):
                    errs.append(f"{e['name']}: {text} out of bounds")
    configs = {c["name"] for c in man.get("configs", [])}
    cells = {w["name"] for w in man.get("workloads", [])}
    e2e = {m["name"] for m in man.get("end_to_end", [])}
    if "setup_s" not in e2e:
        errs.append("no setup_s")
    for c in man.get("configs", []):
        for k in c.get("reduced", []):
            if not NAME_RE.match(k):
                errs.append(f"{c['name']}: bad reduced key {k!r}")
        if not os.path.isfile(os.path.join(ROOT, c["file"])):
            errs.append(f"{c['name']}: no file {c['file']}")
    for w in man.get("workloads", []):
        if w["config"] not in configs:
            errs.append(f"{w['name']}: unknown config")
        if w["chips"] not in (1, 4):
            errs.append(f"{w['name']}: chips {w['chips']}")
        for t in (w["config"], w["traffic"]):
            if not NAME_RE.match(t):
                errs.append(f"{w['name']}: bad name {t!r}")
    for m in man.get("end_to_end", []):
        if m["source"] not in ("host_clock", "device_trace"):
            errs.append(f"{m['name']}: source {m['source']}")
        if not 0.01 <= m["bound"] <= 0.25:
            errs.append(f"{m['name']}: bound {m['bound']}")
        for cell in m.get("workloads", []):
            if cell not in cells:
                errs.append(f"{m['name']}: unknown cell {cell}")
    for m in man.get("per_layer", []):
        if m["source"] not in ("device_trace", "program_span", "program_counter", "host_clock"):
            errs.append(f"{m['name']}: source {m['source']}")
        if m["moves"] not in e2e:
            errs.append(f"{m['name']}: moves {m['moves']}")
        for cell in m.get("workloads", []):
            if cell not in cells:
                errs.append(f"{m['name']}: unknown cell {cell}")
            else:
                moved = [e for e in man["end_to_end"] if e["name"] == m["moves"]]
                if moved and cell not in moved[0].get("workloads", [cell]):
                    errs.append(f"{m['name']}: {cell} does not report {m['moves']}")
        if not os.path.isfile(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py")):
            errs.append(f"{m['name']}: no reader")
    return errs
