"""BENCHMARK.json keeps the contract's name, unit and key rules, and every
file it leads to exists."""

import copy
import importlib
import os

from benchmark.harness import manifest


def test_manifest_keeps_the_rules():
    assert manifest.check(manifest.manifest()) == []


def test_bad_names_and_units_are_caught():
    man = manifest.manifest()
    for field, value in (("name", "has space"), ("name", "a/b"), ("name", "x" * 65), ("unit", "tokens per s"),
                         ("unit", "µs")):
        bad = copy.deepcopy(man)
        bad["end_to_end"][0][field] = value
        assert manifest.check(bad), (field, value)
    bad = copy.deepcopy(man)
    bad["per_layer"][0]["why"] = "not a key a metric may carry"
    assert manifest.check(bad)
    bad = copy.deepcopy(man)
    bad["end_to_end"] = [m for m in bad["end_to_end"] if m["name"] != "setup_s"]
    assert manifest.check(bad)


def test_every_named_file_is_found():
    man = manifest.manifest()
    for c in man["configs"]:
        conf = manifest.config(c["name"])
        assert conf["name"] == c["name"] and sorted(conf["reduced"]) == sorted(c["reduced"])
        assert os.path.isfile(os.path.join(manifest.BENCH_DIR, "flops", f"{c['name']}.json"))
    for w in man["workloads"]:
        mix = manifest.traffic(w["traffic"])
        assert {"cell", "check_steps", "trace_steps"} <= set(mix)
        assert callable(importlib.import_module(f"benchmark.harness.{mix['cell']}_cell").Cell)
        assert set(manifest.limits(w["name"])) == {"first_loss_gap", "grad_gap", "change_gap", "teacher_gap"}
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_each_cell_reports_setup_an_end_to_end_and_a_layer_metric():
    man = manifest.manifest()
    for w in man["workloads"]:
        e2e = {m["name"] for m in manifest.cell_metrics(man, w["name"], False)}
        layer = manifest.cell_metrics(man, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)
