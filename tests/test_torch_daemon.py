"""The port's resident daemon (``daemon.py``) on the CPU (mirrors
tests/test_daemon.py): a ``--device cpu`` daemon subprocess in a private
directory answers ping, verifies wire shuffle entries and transactions on
the host backends (a tampered entry raises ValueError), proves ranges at
n = 8 equal to the host prover under the same seeds; it refuses a client
with a wrong key and answers a pickle frame with "error" without loading
it; its key file is 0600 in a 0700 directory, and it refuses a directory
open to others; a fresh client process loads no CUDA module; shutdown ends
it with exit code 0. Socket paths stay short (AF_UNIX stops at 107 bytes),
so the directory comes from ``tempfile.mkdtemp``, not pytest's tmp_path."""

import dataclasses
import os
import pickle
import shutil
import stat
import subprocess
import sys
import tempfile
from multiprocessing import AuthenticationError
from multiprocessing.connection import Client

import pytest
import torch

from quisquis_tpu_torch import daemon as qdaemon
from quisquis_tpu_torch import serving
from quisquis_tpu_torch.accounts.accounts import Account
from quisquis_tpu_torch.accounts.prover import Prover
from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
from quisquis_tpu_torch.bulletproofs.range_proof import RangeProof
from quisquis_tpu_torch.primitives.keys import RistrettoPublicKey, RistrettoSecretKey
from quisquis_tpu_torch.shuffle.shuffle import Shuffle, ShuffleProof
from quisquis_tpu_torch.transaction import batch_create_transactions
from quisquis_tpu_torch.transaction.workloads import benchmark_requests
from quisquis_tpu_torch.utils import serde

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           OMP_NUM_THREADS="1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here, and in the processes that this module starts."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(prev)


class Evil:
    """Unpickling this creates a file."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


@pytest.fixture(scope="module")
def daemon():
    d = tempfile.mkdtemp(prefix="qq")
    sock = os.path.join(d, "d.sock")
    proc = subprocess.Popen([sys.executable, "-m", "quisquis_tpu_torch.daemon",
                             "--socket", sock, "--device", "cpu"],
                            cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        with qdaemon.DeviceClient(sock, retries=300) as c:   # waits for readiness
            assert c.ping() == "cpu"
        yield proc, d, sock
    finally:
        if proc.poll() is None:
            try:
                qdaemon.DeviceClient(sock, retries=5).shutdown()
                proc.wait(timeout=30)
            except Exception:
                proc.kill()
                proc.wait()
        proc.stdout.close()
        shutil.rmtree(d, ignore_errors=True)


def _shuffle_blobs(count=2):
    r = SeededRng(seed=b"daemon-sh")
    accounts = [Account.generate_account(
        RistrettoPublicKey.from_secret_key(RistrettoSecretKey.random(r), r), r)[0]
        for _ in range(9)]
    blobs = []
    for _ in range(count):
        sh = Shuffle.input_shuffle(accounts, rng=r)
        proof, statement = ShuffleProof.create_shuffle_proof(
            Prover(b"Shuffle", Transcript(b"ShuffleProof"), rng=r), sh, rng=r)
        blobs.append(serde.shuffle_entry_to_bytes(proof, statement, sh.get_inputs_vector(),
                                                  sh.get_outputs_vector()))
    return blobs


def test_modes_and_private_directory(daemon):
    _, d, sock = daemon
    assert stat.S_IMODE(os.stat(d).st_mode) == 0o700
    assert stat.S_IMODE(os.stat(sock + ".key").st_mode) == 0o600
    assert len(qdaemon.read_key(sock + ".key")) == qdaemon.KEY_BYTES
    open_dir = tempfile.mkdtemp(prefix="qq")
    try:
        os.chmod(open_dir, 0o755)
        with pytest.raises(PermissionError, match="0700"):
            qdaemon.DeviceDaemon(os.path.join(open_dir, "d.sock"), device="cpu")
        assert os.listdir(open_dir) == []
    finally:
        shutil.rmtree(open_dir)
    with pytest.raises(ValueError, match="107"):
        qdaemon.DeviceDaemon(os.path.join(d, "x" * 120), device="cpu")


def test_shuffle_verify_and_tamper(daemon):
    _, _, sock = daemon
    blobs = _shuffle_blobs()
    p, s, ins, outs = serde.shuffle_entry_from_bytes(blobs[0])
    p = dataclasses.replace(p, ddh_proof=dataclasses.replace(p.ddh_proof, z=p.ddh_proof.z + 1))
    with qdaemon.DeviceClient(sock) as c:
        assert c.verify_shuffles(blobs, seed=b"s", backend="host") == 2
        with pytest.raises(ValueError):
            c.verify_shuffles([serde.shuffle_entry_to_bytes(p, s, ins, outs), blobs[1]],
                              backend="host")
        with pytest.raises(ValueError):
            c.verify_shuffles([blobs[0][:-3]], backend="host")
        assert c.ping() == "cpu"   # still serving


def test_range_prove_equals_host(daemon):
    _, _, sock = daemon
    n = 8
    values, blindings, seeds = [[3, 200], [0, 255]], [[11, 12], [13, 14]], [b"a" * 32, b"b" * 32]
    with qdaemon.DeviceClient(sock) as c:
        out = c.prove_ranges(n, values, blindings, seeds, backend="host")
    assert len(out) == 2
    for (proof_bytes, commitments), v, b, s in zip(out, values, blindings, seeds):
        want, want_V = RangeProof.prove_multiple(Transcript(b"RangeProof"), v, b, n,
                                                 rng=SeededRng(seed=s))
        assert proof_bytes == want.to_bytes() and commitments == want_V
        RangeProof.from_bytes(proof_bytes).verify_multiple(Transcript(b"RangeProof"),
                                                           commitments, n)


def test_tx_verify(daemon):
    _, _, sock = daemon
    items = batch_create_transactions(benchmark_requests(b"daemon-tx", 2, 1, 9),
                                      range_backend="host")
    pairs = [serving.serialize_transaction(tx, proof) for tx, proof in items]
    with qdaemon.DeviceClient(sock) as c:
        assert c.verify_transactions(pairs, seed=b"t") == 2   # "auto": the host
        with pytest.raises(ValueError):
            c.verify_transactions([pairs[0], (pairs[1][0], pairs[0][1])])


def test_wrong_key_refused_and_pickle_frame_answered_error(daemon):
    _, d, sock = daemon
    with pytest.raises(AuthenticationError):
        Client(sock, "AF_UNIX", authkey=b"\x00" * qdaemon.KEY_BYTES)
    target = os.path.join(d, "pwned")
    with qdaemon.DeviceClient(sock) as c:
        with pytest.raises(RuntimeError, match="bad frame"):
            c.roundtrip(pickle.dumps(Evil(target)))
        with pytest.raises(RuntimeError, match="bad frame"):
            c.roundtrip(qdaemon.encode_request("ping") + b"\x00")
        assert c.ping() == "cpu"
    assert not os.path.exists(target)


CLIENT = r"""
import sys
from quisquis_tpu_torch.daemon import DeviceClient
with DeviceClient(sys.argv[1]) as c:
    assert c.ping() == "cpu"
bad = sorted(m for m in sys.modules
             if m.startswith("quisquis_tpu_torch.ops.cuda_") or m == "torch")
print("LOADED", bad)
"""


def test_fresh_client_loads_no_cuda_module_then_shutdown(daemon):
    proc, _, sock = daemon
    out = subprocess.run([sys.executable, "-c", CLIENT, sock], cwd=REPO, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"
    qdaemon.DeviceClient(sock).shutdown()
    assert proc.wait(timeout=30) == 0
    assert not os.path.exists(sock) and not os.path.exists(sock + ".key")
