"""BENCHMARK.json against the benchmark's contract, and the lookup by name
of each configuration, traffic mix and metric reader."""

import json
import math
import re

import pytest

from qqbench.paths import PKG, ROOT
from qqbench.spec import Spec, reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return Spec.load()


def test_top_level_keys(spec):
    assert set(spec.data) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert spec.data["command"] == ["python3", "qqbench/run.py"]
    assert spec.data["paths"] == ["qqbench"]
    assert 1 <= spec.data["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_budget_of_a_full_check(spec):
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell to compile
    and 1,200 s spare fit into 43,200 s, with the full 24 cells."""
    runs = 2 + 14 * 24
    assert runs * (spec.data["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_keys(spec, section):
    entries = spec.data[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                             "workloads"}}[section]
    for e in entries:
        assert set(e) <= allowed and set(e) >= allowed - {"workloads"}, e["name"]
        lines = [e[k] for k in ("why", "layer") if k in e]
        if section == "configs":
            lines.append(e["source"])
        for line in lines:
            assert 1 <= len(line) <= 200 and "\n" not in line and "\t" not in line


def test_metrics(spec):
    cells = set(spec.workloads)
    for m in list(spec.end_to_end.values()) + list(spec.per_layer.values()):
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m["name"]
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
        assert callable(reader(m["name"]))
    for m in spec.end_to_end.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert spec.end_to_end["setup_s"]["bound"] <= 0.25
    for m in spec.per_layer.values():
        assert m["moves"] in spec.end_to_end
        for w in m["workloads"]:
            reported = {e["name"] for e in spec.metrics_of(spec.workloads[w], False)}
            assert m["moves"] in reported, (m["name"], w)
    layers = {}
    for m in spec.per_layer.values():
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("name", ["n9-block32-batched", "n9-4x4-build16-batched",
                                  "n64-shuffle64-batched"])
def test_each_cell_resolves_and_reports(spec, name):
    from qqbench import entries

    cell = spec.workload(name)
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    config, mix = spec.config(cell), spec.traffic(cell)
    assert config["name"] == cell["config"] and mix["entry"] in entries.names()
    e2e = [m["name"] for m in spec.metrics_of(cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(cell, True)


def test_configs_keep_the_reference_widths(spec):
    used = {w["config"] for w in spec.data["workloads"]}
    assert used == set(spec.configs)
    widths = {"anonymity_set_size", "shuffle_rows", "shuffle_columns", "range_bits",
              "bp_gens_capacity", "bp_party_capacity", "scalar_bits", "values_per_range_proof",
              "senders", "receivers"}
    for entry in spec.data["configs"]:
        assert entry["file"].startswith("qqbench/")
        with open(ROOT / entry["file"]) as f:
            cfg = json.load(f)
        # every cut is of scale, stated in the file with its cause; no width is cut
        assert not set(entry["reduced"]) & widths
        assert all(k in cfg and k in cfg["cut"] for k in entry["reduced"])
        assert cfg["source"] == entry["source"]
        assert cfg["scalar_bits"] == 253
        assert math.isqrt(cfg["anonymity_set_size"]) ** 2 == cfg["anonymity_set_size"]
        if "range_bits" in cfg:   # a transaction's configuration
            assert cfg["range_bits"] == 64
            assert (cfg["bp_gens_capacity"], cfg["bp_party_capacity"]) == (64, 16)
            assert cfg["anonymity_set_size"] == 9   # the reference's fixed 3x3 shuffle
            assert cfg["values_per_range_proof"] == cfg["senders"] + cfg["receivers"]
            assert entry["reduced"] == []
        else:                     # a standalone shuffle's, at a stated square size
            assert cfg["shuffle_rows"] * cfg["shuffle_columns"] == cfg["anonymity_set_size"]
            assert (cfg["proof_label"], cfg["transcript_label"]) == ("Shuffle", "ShuffleProof")
            assert "anonymity_set_size" in cfg["assumed"]
    files = [e["file"] for e in spec.data["configs"]]
    assert len(files) == len(set(files))


def test_unknown_names_are_refused(spec):
    with pytest.raises(KeyError):
        spec.workload("no-such-cell")
    with pytest.raises(FileNotFoundError):
        reader("no_such_metric")


def test_the_harness_names_no_file_outside_its_folder(spec):
    for word in spec.data["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert word.startswith("qqbench/")
    assert (PKG / "run.py").exists()
