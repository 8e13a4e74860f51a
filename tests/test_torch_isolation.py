"""The port imports neither JAX nor the JAX package, and its entry points do
not carry on on the CPU unless asked to."""

import glob
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run in a fresh interpreter: tests/conftest.py imports jax in this one
PROBE = r"""
import pkgutil, importlib, sys
import quisquis_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(quisquis_tpu_torch.__path__, "quisquis_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from quisquis_tpu_torch.accounts.accounts import Account
from quisquis_tpu_torch.accounts.device_accounts import update_accounts_device
from quisquis_tpu_torch.accounts.transcript import SeededRng
from quisquis_tpu_torch.primitives.keys import RistrettoPublicKey, RistrettoSecretKey
r = SeededRng(seed=b"iso")
accs = []
for _ in range(2):
    pk = RistrettoPublicKey.from_secret_key(RistrettoSecretKey.random(r), r)
    accs.append(Account.generate_account(pk, r)[0])
uks = [r.random_scalar() for _ in range(2)]
cs = [r.random_scalar() for _ in range(2)]
dev = update_accounts_device(accs, [3, 4], uks, cs, device="cpu")
host = [Account.update_account(a, b, u, c) for a, b, u, c in zip(accs, [3, 4], uks, cs)]
assert [a.as_bytes() for a in dev] == [a.as_bytes() for a in host]
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "quisquis_tpu"
             or m.startswith("quisquis_tpu."))
print("MODULES", len(mods), "FORBIDDEN", bad)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here, and in the processes that this module starts."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(prev)


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = proc.stdout.strip().splitlines()[-1]
    assert line.endswith("FORBIDDEN []"), line
    assert int(line.split()[1]) >= 73
    # an import inside a function runs only when the function does: no source
    # line of the port imports either, wherever it stands
    forbidden = re.compile(r"^\s*(import|from)\s+(jax|quisquis_tpu)(\.|\s|$)", re.M)
    sources = glob.glob(os.path.join(REPO, "quisquis_tpu_torch", "**", "*.py"), recursive=True)
    sources.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(sources) >= 75
    for path in sources:
        with open(path) as f:
            found = forbidden.search(f.read())
        assert found is None, f"{path}: {found.group(0).strip()}"


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from quisquis_tpu_torch import entry
    from quisquis_tpu_torch.accounts.device_accounts import update_accounts_device
    from quisquis_tpu_torch.accounts.transcript import Transcript
    from quisquis_tpu_torch.bulletproofs import device_verify as dv
    from quisquis_tpu_torch.bulletproofs.range_proof import RangeProof
    from quisquis_tpu_torch.device import resolve_device
    from quisquis_tpu_torch.ops import batch as qb
    from quisquis_tpu_torch.ops import exact as ex
    from quisquis_tpu_torch.ops import msm as qmsm
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        qb.scalars_to_device([1, 2])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        entry.example_inputs(2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        update_accounts_device([], [], [], [])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        qmsm.msm_host([1], [ex.BASEPOINT])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        dv.DeviceRangeVerifier(8, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        dv.get_device_range_verifier(8, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        RangeProof.batch_verify([(None, [b""], Transcript(b"RangeProof"))], 8)
    from quisquis_tpu_torch.accounts import device_verifier as dvf
    from quisquis_tpu_torch.accounts.deferred import DeferredPointChecks
    from quisquis_tpu_torch.shuffle import device_verify as sdv
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        dvf.zero_balance_encodings([], [], 1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        dvf.delta_compact_encodings([], [], [], [], [], 1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        sdv.DeviceShuffleVerifier(2, 2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        sdv.get_device_shuffle_verifier(2, 2)
    checks = DeferredPointChecks(b"iso")
    checks.check([1], [ex.BASEPOINT], "iso")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        checks.verify(backend="device")
    import types
    from quisquis_tpu_torch.accounts.transcript import SeededRng
    from quisquis_tpu_torch.bulletproofs import device_prove as dp
    from quisquis_tpu_torch.shuffle import device_prove as sdp
    from quisquis_tpu_torch.shuffle.shuffle import batch_create_shuffle_proofs
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        dp.DeviceRangeProver(8, 1, 2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        dp.get_device_range_prover(8, 1, 2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        RangeProof.prove_batch([(Transcript(b"RangeProof"), [1], [1], SeededRng(b"iso"))], 8)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        sdp.DeviceShuffleProver(2, 2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        sdp.get_device_shuffle_prover(2, 2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        batch_create_shuffle_proofs([types.SimpleNamespace(inputs=[None] * 4)] * 4)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        checks.verify()   # "auto" resolves the device whichever backend it takes
    from quisquis_tpu_torch.transaction import (batch_create_transactions,
                                                batch_verify_transactions)
    for backend in ("auto", "device-batched"):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            batch_create_transactions([{}], range_backend=backend)   # before any host work
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            batch_verify_transactions([], backend=backend)
    # the serving layer: every device backend resolves its device before
    # it starts a pool or reads a request
    from quisquis_tpu_torch import daemon, serving
    from quisquis_tpu_torch.primitives.schnorr import Signature
    from quisquis_tpu_torch.utils.warmup import warmup
    for backend in ("device", "device-batched"):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            serving.VerificationService(workers=1, backend=backend)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            serving.ShuffleVerificationService(workers=1, backend=backend)
    for backend in ("auto", "device-batched"):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            serving.RangeProvingService(backend=backend)
    for backend in ("auto", "device"):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            Signature.batch_verify([], backend=backend)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        warmup([("shuffle", 2, 2)])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        daemon.DeviceDaemon("/nonexistent/d.sock")
    assert resolve_device("cpu").type == "cpu"


def _constructors():
    import numpy as np
    from quisquis_tpu_torch.ops import exact as ex
    from quisquis_tpu_torch.ops import field as fe
    from quisquis_tpu_torch.accounts.transcript import Transcript
    from quisquis_tpu_torch.ops import device_strobe as ds
    from quisquis_tpu_torch.ops import point as pt
    from quisquis_tpu_torch.ops import scalar_field as sf
    b32, b64 = np.zeros((1, 32), np.uint8), np.zeros((1, 64), np.uint8)
    return {
        "fe.zeros": lambda **kw: fe.zeros((1,), **kw),
        "fe.ones": lambda **kw: fe.ones((1,), **kw),
        "fe.const": lambda **kw: fe.const(5, (1,), **kw),
        "fe.from_bytes": lambda **kw: fe.from_bytes(b32, **kw),
        "pt.identity": lambda **kw: pt.identity((1,), **kw),
        "pt.basepoint": lambda **kw: pt.basepoint((1,), **kw),
        "pt.from_exact": lambda **kw: pt.from_exact(ex.BASEPOINT, (1,), **kw),
        "pt.from_exact_batch": lambda **kw: pt.from_exact_batch([ex.BASEPOINT], **kw),
        "pt.from_uniform_bytes": lambda **kw: pt.from_uniform_bytes(b64, **kw),
        "sf.zeros": lambda **kw: sf.zeros((1,), **kw),
        "sf.one": lambda **kw: sf.one((1,), **kw),
        "sf.const": lambda **kw: sf.const(5, (1,), **kw),
        "sf.scalars_to_dev": lambda **kw: sf.scalars_to_dev([3], **kw),
        "DeviceStrobe": lambda **kw: ds.DeviceStrobe(b"iso", (1,), **kw).state,
        "DeviceTranscript": lambda **kw: ds.DeviceTranscript(b"iso", (1,), **kw).strobe.state,
        "DeviceTranscript.from_host_transcripts":
            lambda **kw: ds.DeviceTranscript.from_host_transcripts([Transcript(b"iso")],
                                                                   **kw).strobe.state,
    }


@pytest.mark.parametrize("name", sorted(_constructors()))
def test_constructor_defaults_to_cuda(name):
    make = _constructors()[name]

    def on(out):
        return {t.device.type for t in (out if isinstance(out, tuple) else (out,))}

    assert on(make(device="cpu")) == {"cpu"}
    if torch.cuda.is_available():
        assert on(make()) == {"cuda"}
        return
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make()
