"""In a fresh interpreter, each cell's imports load no module whose
top-level name is jax, jaxlib, flax or quisquis_tpu (compared whole:
quisquis_tpu_torch is the port), and the reference, with the generator
that drives it, loads nothing of quisquis_tpu_torch either."""

import json
import subprocess
import sys

import pytest

from qqbench.paths import ROOT

SHOW = ("import json, sys; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
                          + code + "\n" + SHOW],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("name", ["n9-block32-batched", "n9-4x4-build16-batched",
                                  "n64-shuffle64-batched"])
def test_a_cells_imports_load_no_jax_and_no_jax_package(name):
    code = f"""
from qqbench import run, entries, gen, trace, probes, roofline, readers, procs, control, hostprobe
from qqbench.spec import Spec, reader
spec = Spec.load()
cell = spec.workload({name!r})
entries.load(spec.traffic(cell)["entry"])
for m in spec.metrics_of(cell, False) + spec.metrics_of(cell, True):
    reader(m["name"])
import quisquis_tpu_torch
from quisquis_tpu_torch import serving
from quisquis_tpu_torch.transaction import transaction
from quisquis_tpu_torch.accounts import deferred
from quisquis_tpu_torch.bulletproofs import range_proof
from quisquis_tpu_torch.ops import msm, cuda_build
from quisquis_tpu_torch.utils import serde, metrics
"""
    mods = loaded(code)
    assert "quisquis_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "quisquis_tpu"}


def test_the_reference_loads_nothing_of_the_port_or_jax():
    code = """
from qqbench import gen
from qqbench.ref.utils import serde
from qqbench.ref.transaction import workloads, transaction
from qqbench.ref.accounts import deferred
reqs = gen.wire_requests(b"isolation", 1, {"anonymity_set_size": 9, "senders": 1})
pair = gen.ref_build(reqs[0])
assert gen.ref_verify(pair, bytes(32))
for kind in gen.TAMPER_KINDS:
    assert not gen.ref_verify(gen.tamper(pair, kind), bytes(32))
from qqbench.entries import verify_shuffle_wire as vs
cfg = {"anonymity_set_size": 4, "proof_label": "Shuffle", "transcript_label": "ShuffleProof"}
blob = vs.ref_prove(b"isolation", cfg, 0)
assert vs.ref_verify(blob, cfg, bytes(32))
for kind in vs.TAMPER_KINDS:
    assert not vs.ref_verify(vs.tamper(blob, kind), cfg, bytes(32))
from qqbench import hostprobe
hostprobe.probe()
"""
    mods = loaded(code)
    assert "qqbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "quisquis_tpu", "quisquis_tpu_torch"}


def test_the_forbidden_names_are_compared_whole():
    from qqbench.run import forbidden_modules

    assert forbidden_modules(["quisquis_tpu_torch.ops", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["quisquis_tpu.ops.field", "jax._src", "flax"]) == [
        "flax", "jax", "quisquis_tpu"]
