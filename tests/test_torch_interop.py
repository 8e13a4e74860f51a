"""Carrying field elements, points, digits, the fixed-base table, scalars,
Keccak states and the range verifier's resident generators between the JAX
package and the port."""

import random

import numpy as np
import pytest
import torch

from quisquis_tpu.bulletproofs.device_verify import DeviceRangeVerifier as JaxDeviceRangeVerifier
from quisquis_tpu.ops import field as jfe
from quisquis_tpu.ops import point as jpt
from quisquis_tpu.ops import scalar_field as jsf
from quisquis_tpu.ops.pallas_point import _niels_base_table
from quisquis_tpu_torch import interop
from quisquis_tpu_torch.bulletproofs.device_verify import DeviceRangeVerifier
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.ops import field as fe
from quisquis_tpu_torch.ops import point as pt
from quisquis_tpu_torch.ops import scalar_field as sf

rng = random.Random(2024)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here, and in the processes that this module starts."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(prev)


def test_limbs_round_trip():
    xs = [rng.randrange(ex.P) for _ in range(12)] + [0, 1, ex.P - 1, ex.P - 19]
    jl = jfe.from_int_batch(xs).reshape(2, 8, jfe.NLIMBS)
    port = interop.limbs_from_jax(jl, device="cpu")
    assert port.shape == (2, 8, fe.NLIMBS)
    assert fe.to_int_batch(port) == xs
    back = interop.limbs_to_jax(port)
    assert back.dtype == np.int32 and np.array_equal(back, jl)
    # loose (non-canonical) JAX limbs arrive as their value mod p
    worst = np.array([jfe.CONTRACT] * 3, dtype=np.int32)
    assert fe.to_int_batch(interop.limbs_from_jax(worst, device="cpu")) == \
        jfe.to_int_batch(worst)
    with pytest.raises(ValueError):
        interop.limbs_from_jax(np.zeros((2, 10), dtype=np.int32), device="cpu")


def test_ext_point_and_nibbles_round_trip():
    pts = [ex.pt_base_mul(rng.randrange(1, ex.L)) for _ in range(4)]
    jp = jpt.from_exact_batch(pts)
    port = interop.ext_point_from_jax([np.asarray(c) for c in jp], device="cpu")
    assert all(ex.pt_eq(a, b) for a, b in zip(pt.to_exact_batch(port), pts))
    back = interop.ext_point_to_jax(port)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(back, jp))
    nib = jpt.scalars_to_nibbles([rng.randrange(ex.L) for _ in range(4)])
    assert np.array_equal(interop.nibbles_from_jax(nib, device="cpu").numpy(), nib)
    with pytest.raises(ValueError):
        interop.nibbles_from_jax(nib + 16, device="cpu")


def test_niels_table_equals_jax():
    """The port's own fixed-base table equals _niels_base_table() value for
    value where both have the entry: windows 0..63, multiples 1..8 (the
    port's signed digits need no 9..15 and no 0, and add a 65th window,
    whose entries are held against exact.py)."""
    carried = interop.niels_table_from_jax(_niels_base_table(), device="cpu")
    own = pt.niels_base_table_np()
    assert carried.shape == (64, 16, 3, fe.NLIMBS)
    assert own.shape == (65, 8, pt.BASE_ENTRY_INTS)
    entries = own[..., :3 * fe.NLIMBS].reshape(65, 8, 3, fe.NLIMBS)
    assert np.array_equal(carried.numpy()[:, 1:9], entries[:64])
    assert not own[..., 3 * fe.NLIMBS:].any()
    for k in (1, 8):
        X, Y, Z, _ = ex.pt_base_mul(k * 16**64 % ex.L)
        x, y = X * ex.fe_invert(Z) % ex.P, Y * ex.fe_invert(Z) % ex.P
        want = [(y + x) % ex.P, (y - x) % ex.P, x * y * ex.D2 % ex.P]
        assert fe.to_int_batch(entries[64, k - 1]) == want


def test_scalar_limbs_and_keccak_states_round_trip():
    xs = [rng.randrange(ex.L) for _ in range(9)] + [0, 1, ex.L - 1]
    jl = jsf.from_int_batch(xs).reshape(3, 4, jsf.NLIMBS)
    port = interop.scalar_limbs_from_jax(jl, device="cpu")
    assert port.shape == (3, 4, sf.NLIMBS) and port.dtype == sf.zeros((), "cpu").dtype
    assert sf.to_int_batch(port) == xs
    back = interop.scalar_limbs_to_jax(sf.add(port, sf.zeros((3, 4), "cpu")))  # loose limbs
    assert back.dtype == np.int32 and np.array_equal(back, jl)
    states = np.random.default_rng(3).integers(0, 256, (2, 5, 200)).astype(np.int32)
    st = interop.keccak_states_from_jax(states, device="cpu")
    assert st.shape == (2, 5, 200) and st.numpy().dtype == np.uint8
    assert np.array_equal(interop.keccak_states_to_jax(st), states)
    with pytest.raises(ValueError):
        interop.keccak_states_from_jax(states[..., :100], device="cpu")


def test_verifier_static_points_equal_jax():
    """What the range verifier keeps between calls, its 2 + 2nm resident
    generator points, is the same in both packages (constructing the JAX
    verifier compiles nothing)."""
    n, m = 8, 2
    theirs = JaxDeviceRangeVerifier(n, m, 3)._static
    ours = DeviceRangeVerifier(n, m, 3, device="cpu")._static
    carried = interop.ext_point_from_jax([np.asarray(c) for c in theirs], device="cpu")
    assert carried.x.shape == ours.x.shape == (2 + 2 * n * m, fe.NLIMBS)
    assert torch.equal(pt.compress_to_bytes_tensor(carried), pt.compress_to_bytes_tensor(ours))
    assert all(np.array_equal(a, np.asarray(b))
               for a, b in zip(interop.ext_point_to_jax(ours), theirs))
