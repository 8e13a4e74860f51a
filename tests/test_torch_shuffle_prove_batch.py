"""``batch_create_shuffle_proofs(backend="device-batched")`` on the CPU: 3
shuffles (m = 2) run as a bucket of 4 lanes (the pad lane draws from a
stream of its own) and come back in order, equal field for field to the
host backend's proofs under the same per-lane streams (helpers in
tests/test_torch_shuffle_prove.py)."""

import copy

import pytest
import torch

from quisquis_tpu_torch.shuffle import device_prove as sdp
from quisquis_tpu_torch.shuffle import shuffle as sh
from tests.test_torch_shuffle_prove import assert_same_fields, host_verifies, lanes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_batch_create_device_batched_bucket():
    batch = lanes(b"dsp-bucket", 2, 3, jax=False)
    sdp._PROVER_CACHE.clear()
    got = sh.batch_create_shuffle_proofs([s for s, *_ in batch],
                                         [copy.deepcopy(r) for _, r, *_ in batch],
                                         backend="device-batched", device="cpu")
    assert [k[:2] for k in sdp._PROVER_CACHE] == [(2, 4)]
    assert len(got) == 3
    for (_, _, host, _), out in zip(batch, got):
        assert_same_fields(out, host)
    host_verifies(batch[2][0], *got[2])
