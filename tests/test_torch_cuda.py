"""The port's CUDA kernels on the card (marked ``cuda``; skipped without a
GPU). Run on a GPU machine from the repository root, without the JAX
test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import random

import pytest
import torch

from quisquis_tpu_torch.ops import cuda_point as kp
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.ops import point as pt

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _scalars(n):
    r = random.Random(n)
    edge = [0, 1, ex.L - 1, 2**252, int("f" * 63, 16) % ex.L, 15, 16, 2**252 - 1]
    return edge + [r.randrange(ex.L) for _ in range(n - len(edge))]


def test_kernels_equal_plain_on_a_ragged_batch(dev):
    n = 300  # not a multiple of the block size
    nib = torch.as_tensor(pt.scalars_to_nibbles(_scalars(n)), device=dev)
    p = pt.base_mul(torch.flip(nib, dims=(0,)).contiguous())
    before = dict(kp.LAUNCHES)
    k_s, k_b = kp.scalar_mul(nib, p), kp.base_mul(nib)
    assert kp.LAUNCHES == {k: v + 1 for k, v in before.items()}
    # the same arithmetic in the same order: limb-identical to the plain versions
    assert all(torch.equal(a, b) for a, b in zip(k_s, pt.scalar_mul(nib, p)))
    assert all(torch.equal(a, b) for a, b in zip(k_b, pt.base_mul(nib)))


def test_wrappers_check_their_inputs(dev):
    nib = torch.zeros((4, 64), dtype=torch.int32, device=dev)
    p = pt.identity((4,), dev)
    with pytest.raises(TypeError):
        kp.base_mul(nib.long())
    with pytest.raises(ValueError):
        kp.base_mul(torch.zeros((64, 4), dtype=torch.int32, device=dev).t())
    with pytest.raises(ValueError):
        kp.scalar_mul(nib, pt.identity((4,), "cpu"))
    with pytest.raises(ValueError):
        kp.scalar_mul(nib[:3], p)
    before = dict(kp.LAUNCHES)
    empty = kp.scalar_mul(nib[:0], pt.ExtPoint(*(c[:0] for c in p)))
    assert empty.x.shape == (0, 10) and kp.LAUNCHES == before
