"""The port's DeviceShuffleProver at m = 3 (the reference's 3x3 anonymity
set), B = 2, on the CPU: proofs and statements equal the port's and the JAX
package's host provers field for field under the same SeededRng streams,
and the port's host verifier accepts them (helpers and m = 2 in
tests/test_torch_shuffle_prove.py)."""

import copy

import pytest
import torch

from quisquis_tpu_torch.shuffle import device_prove as sdp
from tests.test_torch_shuffle_prove import assert_same_fields, host_verifies, lanes

B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_device_prove_equals_host_m3():
    batch = lanes(b"dsp-3", 3, B)
    got = sdp.get_device_shuffle_prover(3, B, device="cpu").prove(
        [s for s, *_ in batch], [copy.deepcopy(r) for _, r, *_ in batch])
    for (shuffle, _, host, jax), out in zip(batch, got):
        assert_same_fields(out, host)
        assert_same_fields(out, jax)
        host_verifies(shuffle, *out)
