"""The port's DeviceShuffleVerifier on the CPU rejects each tampering of a
proof in tests/test_device_shuffle_verify.py (a point, a Hadamard scalar,
the DDH response, a multi-exponentiation commitment) in one lane of a
B = 2 batch at m = 2, and the JAX host verifier rejects that lane too; the
statement tampering is in tests/test_torch_shuffle_verify.py. Exact:
accept or reject."""

import pytest
import torch

from tests.test_torch_shuffle import TAMPERS, host_accepts, jax_entries, tampered
from tests.test_torch_shuffle_verify import device_accepts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def honest():
    return jax_entries(b"torch-dsv-tamper", 2, 2)


@pytest.mark.parametrize("what", sorted(set(TAMPERS) - {"svp statement b"}))
def test_rejects_tampered_lane(honest, what):
    entries = tampered(honest, what, lane=1)
    assert host_accepts(entries[0], port=False)
    assert not host_accepts(entries[1], port=False)
    assert not device_accepts(2, entries, seed=b"t-" + what.encode())
