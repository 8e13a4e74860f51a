"""Entries are files: each is found by its file name, and a new file is a new
entry that a cell can drive through the whole run, with no other edit."""

import argparse
import json

import pytest

from qqbench import entries, procs
from qqbench.run import run_cell
from qqbench.spec import Spec

ECHO = '''
"""echo: a test entry that answers every call with its item."""

from qqbench.stats import Call


class Echo:
    kind = "echo"

    @staticmethod
    def inputs(config, mix, seed):
        return {"n": int(mix["n"]), "seed": seed}, 0.0

    @staticmethod
    def install_spans(spans):
        pass

    def __init__(self, config, mix, inputs, seed, device):
        self.inputs = inputs

    def items(self):
        k = 0
        while True:
            yield k % self.inputs["n"]
            k += 1

    def call(self, item, out: Call):
        out.size, out.done, out.verdict, out.output = 1, 1, True, item

    def settle(self, call):
        pass

    def judge(self, calls, config, mix, seed):
        wrong = sum(1 for c in calls if c.output != c.item)
        return {"wrong_echoes": (wrong, 0)}

    def close(self):
        pass


Entry = Echo
'''


def test_the_entries_are_the_files():
    assert entries.names() == ["build", "verify_shuffle_wire", "verify_wire"]
    for name in entries.names():
        cls = entries.load(name)
        assert callable(cls.inputs) and callable(cls.install_spans) and cls.kind
    assert entries.load("verify_wire") is entries.VerifyWire
    assert entries.load("verify_shuffle_wire") is entries.VerifyShuffleWire
    assert entries.load("build") is entries.Build
    with pytest.raises(KeyError):
        entries.load("no_such_entry")
    with pytest.raises(AttributeError):
        entries.NoSuchEntry


@pytest.fixture
def echo_dir(tmp_path, monkeypatch):
    """A copy of the entries' folder with one more file in it, echo.py."""
    folder = tmp_path / "entries"
    folder.mkdir()
    for p in entries.DIR.glob("*.py"):
        if p.name != "__init__.py":
            (folder / p.name).write_text(p.read_text())
    (folder / "echo.py").write_text(ECHO)
    monkeypatch.setattr(entries, "DIR", folder)
    monkeypatch.setattr(entries, "__path__", [str(folder)])
    yield folder


def test_a_new_file_is_a_new_entry_that_a_cell_drives(echo_dir, tmp_path):
    assert "echo" in entries.names() and entries.load("echo").kind == "echo"
    (tmp_path / "echo.json").write_text(json.dumps({"name": "echo-config"}))
    spec = Spec({"configs": [{"name": "echo-config", "file": "echo.json"}],
                 "workloads": [{"name": "echo-cell", "config": "echo-config",
                                "traffic": "echo-mix", "chips": 1}],
                 "end_to_end": [{"name": "setup_s", "unit": "s"}], "per_layer": []},
                root=tmp_path)
    spec.traffic = lambda cell: {"name": "echo-mix", "entry": "echo", "n": 3}
    args = argparse.Namespace(workload="echo-cell", seed=2 ** 33 + 5, seconds=0.2, trace=0)
    try:
        result, compared = run_cell(args, spec, spec.workload("echo-cell"), require_card=False,
                                    entry_factory=lambda cls, *a: cls(*a, "cpu"))
    finally:
        procs.stop_children()
    assert result["correct"] and compared["wrong_echoes"] == (0, 0)
    assert result["attempted"] > 3 and "setup_s" in result["metrics"]
