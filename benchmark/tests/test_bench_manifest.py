"""BENCHMARK.json against its contract's letter, and the harness finding a
configuration, mix, limits and metric reader by name alone."""
import json
import re
import shutil
import time

import pytest
import torch

from benchmark.harness.manifest import ROOT, Manifest
from benchmark.harness.runner import run_cell
from benchmark.tests.tiny import make_tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = Manifest()
B = MAN.data


def test_keys_and_names():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in B["configs"]] + [w["name"] for w in B["workloads"]]
    names += [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    names += [w[k] for w in B["workloads"] for k in ("config", "traffic")]
    names += [k for c in B["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [x["name"] for x in B[group]]
        assert len(ns) == len(set(ns)), group
    assert len({(w["config"], w["traffic"]) for w in B["workloads"]}) == len(B["workloads"])
    assert all(w["chips"] == 1 for w in B["workloads"])
    assert len(json.dumps(B)) <= 64 * 1024


def test_entries_have_only_their_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in B["workloads"]:
        e2e = {m["name"] for m in MAN.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert MAN.per_layer(w["name"]), w["name"]


def test_moves_names_an_end_to_end_metric_of_every_cell_of_the_metric():
    e2e = {m["name"] for m in B["end_to_end"]}
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in MAN.end_to_end(w)}, (m["name"], w)


def test_every_named_file_exists_and_declares_its_unit():
    for w in B["workloads"]:
        MAN.mix(w["traffic"])
        MAN.limits(w["name"])
    for m in B["per_layer"]:
        assert MAN.metric_reader(m["name"]).UNIT == m["unit"], m["name"]


def test_a_dropped_in_config_mix_and_metric_are_found_by_name(tmp_path):
    """A later cell adds files only: its configuration, mix, limits and
    metric reader are found through BENCHMARK.json, no other file edited."""
    torch.set_num_threads(2)
    root = make_tiny_root(tmp_path)
    bench = root / "benchmark"
    shutil.copy(bench / "configs" / "hydrant.json", bench / "configs" / "hydrant_copy.json")
    mix = json.loads((bench / "mixes" / "sample.json").read_text())
    mix["check_steps"] = 2
    (bench / "mixes" / "sample_short.json").write_text(json.dumps(mix))
    (bench / "limits" / "hydrant_copy.sample_short.json").write_text(
        (bench / "limits" / "hydrant.sample.json").read_text())
    (bench / "metrics" / "ddpm_steps_traced.sample.py").write_text(
        'UNIT = "launches"\n\n\ndef read(run):\n    return float(run.units)\n')
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "hydrant_copy", "source": "https://example.org/copy",
                            "file": "benchmark/configs/hydrant_copy.json", "reduced": [], "why": "a copy"})
    data["workloads"].append({"name": "hydrant_copy.sample_short", "config": "hydrant_copy",
                              "traffic": "sample_short", "chips": 1, "why": "a dropped-in cell"})
    data["end_to_end"][[m["name"] for m in data["end_to_end"]].index("sample_grid_s")]["workloads"].append(
        "hydrant_copy.sample_short")
    data["per_layer"].append({"name": "ddpm_steps_traced.sample", "unit": "launches", "better": "higher",
                              "source": "program_counter", "layer": "sampler", "moves": "sample_grid_s",
                              "workloads": ["hydrant_copy.sample_short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    man = Manifest(root)
    r = run_cell(man, "hydrant_copy.sample_short", 9, 0.2, False, "cpu", time.perf_counter(), log=lambda s: None)
    assert r["correct"] and set(r["metrics"]) == {"setup_s", "sample_grid_s"}
    r = run_cell(man, "hydrant_copy.sample_short", 9, 0.2, True, "cpu", time.perf_counter(), log=lambda s: None)
    assert r["metrics"]["ddpm_steps_traced.sample"]["value"] == r["attempted"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark").rglob("*")), ids=lambda p: str(p.relative_to(ROOT)))
def test_file_names_use_name_characters(path):
    if "__pycache__" in path.parts:
        return
    assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(ROOT)))
