"""The port's CUDA kernels on the card (marked ``cuda``; skipped without a
GPU). Run on a GPU machine from the repository root, without the JAX
test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import random

import pytest
import torch

from quisquis_tpu_torch.ops import cuda_keccak as kk
from quisquis_tpu_torch.ops import cuda_point as kp
from quisquis_tpu_torch.ops import device_keccak as dk
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.ops import field as fe
from quisquis_tpu_torch.ops import msm as qmsm
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
    # scalar_mul's edge cases: integers up to 2^256 - 1 (a carry into the
    # 65th signed digit) on the identity and on points with 8-torsion
    raw = [2**256 - 1, 8 * 16**63 + 5, 15 * 16**63 + 7, 2**256 - 1, ex.L - 1]
    nib_sm = nib.clone()
    nib_sm[:5] = torch.as_tensor([[(v >> (4 * w)) & 15 for w in range(64)] for v in raw],
                                 dtype=torch.int32, device=dev)
    t8 = ex.eight_torsion()
    host = pt.to_exact_batch(pt.ExtPoint(*(c[:5] for c in p)))
    host[2:5] = [ex.IDENTITY, t8, ex.pt_add(host[4], t8)]
    for c, e in zip(p, pt.from_exact_batch(host, dev)):
        c[:5] = e
    before = dict(kp.LAUNCHES)
    k_s, k_b = kp.scalar_mul(nib_sm, p), kp.base_mul(nib_sm)
    assert kp.LAUNCHES == {k: v + (k in ("scalar_mul", "base_mul")) for k, v in before.items()}
    # the same arithmetic in the same order: limb-identical to the plain versions
    assert all(torch.equal(a, b) for a, b in zip(k_s, pt.scalar_mul(nib_sm, p)))
    got = pt.to_exact_batch(pt.ExtPoint(*(c[:5] for c in k_s)))
    assert all(ex.pt_same(g, ex.pt_mul_int(v, q)) for g, v, q in zip(got, raw, host))
    assert all(torch.equal(a, b) for a, b in zip(k_b, pt.base_mul(nib_sm)))
    got = pt.to_exact_batch(pt.ExtPoint(*(c[:5] for c in k_b)))
    assert all(ex.pt_same(g, ex.pt_base_mul(v % ex.L)) for g, v in zip(got, raw))
    # msm_table on 300 points (8 a block: the last block part full), the
    # identity and 8-torsion points among them
    table = kp.msm_table(p)
    assert all(torch.equal(a, b) for a, b in zip(table, qmsm.msm_table(p)))


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


def test_msm_stages_equal_plain_in_rows_mode(dev):
    # 2 tiles a row (one slice), 5 (two slices, uneven), 9 (four, uneven)
    for k in (150, 600, 1100):
        _rows_mode_case(dev, k)


def _rows_mode_case(dev, k):
    rows = 8
    r = random.Random(5)
    nib = torch.as_tensor(pt.scalars_to_nibbles(_scalars(rows * k)), device=dev)
    p = kp.base_mul(torch.as_tensor(
        pt.scalars_to_nibbles([r.randrange(ex.L) for _ in range(rows * k)]), device=dev))
    nib_rk = nib.reshape(rows, k, 64)
    p_rk = pt.ExtPoint(*(c.reshape(rows, k, fe.NLIMBS) for c in p))
    digits, flat = kp.pad_rows(nib_rk, p_rk)
    before = dict(kp.LAUNCHES)
    table = kp.msm_table(flat)
    sums = kp.msm_window_sums(digits, table, rows)
    out = kp.msm_tail(sums)
    stages = ("msm_table", "msm_acc", "msm_tail")
    assert kp.LAUNCHES == {k_: v + (k_ in stages) for k_, v in before.items()}
    # the same schedule and layouts: limb-identical to the plain versions
    assert all(torch.equal(a, b) for a, b in zip(table, qmsm.msm_table(flat)))
    assert all(torch.equal(a, b) for a, b in zip(sums, qmsm.msm_window_sums(digits, table, rows)))
    assert all(torch.equal(a, b) for a, b in zip(out, qmsm.msm_tail(sums)))
    assert all(torch.equal(a, b) for a, b in zip(qmsm.msm_rows(nib_rk, p_rk), out))
    one = qmsm.msm(nib[:k], pt.ExtPoint(*(c[:k] for c in p)))
    assert all(torch.equal(a, b[0]) for a, b in zip(one, out))
    scalars = [int(sum(int(d) << (4 * w) for w, d in enumerate(row))) for row in nib.tolist()]
    host = pt.to_exact_batch(p)
    got = pt.to_exact_batch(out)
    for i in range(rows):
        want = ex.pt_msm(scalars[i * k:(i + 1) * k], host[i * k:(i + 1) * k])
        assert ex.pt_same(got[i], want)
    with pytest.raises(ValueError):
        kp.msm_window_sums(digits[:, :-1].contiguous(), table, rows)
    with pytest.raises(ValueError):
        kp.msm_tail(pt.ExtPoint(*(c[..., :64].contiguous() for c in sums)))


@pytest.mark.parametrize("n", [1, 2, 64, 1000, 1024, 4097])
def test_keccak_equals_plain(dev, n):
    """One state a warp, four a block: n = 2 and 4,097 leave blocks part
    full."""
    gen = torch.Generator().manual_seed(n)
    st = torch.randint(0, 256, (n, 200), generator=gen, dtype=torch.uint8).to(dev)
    before = kp.LAUNCHES["keccak_f1600"]
    got = kk.f1600(st)
    assert kp.LAUNCHES["keccak_f1600"] == before + 1
    assert torch.equal(got, dk.f1600_plain(st)) and torch.equal(dk.f1600(st), got)
    with pytest.raises(TypeError):
        kk.f1600(st.int())
    with pytest.raises(ValueError):
        kk.f1600(st[:, :100])
