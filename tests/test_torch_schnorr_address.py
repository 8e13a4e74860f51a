"""The port's zkSchnorr signatures (``primitives/schnorr.py``,
``RistrettoPublicKey.sign_msg``/``verify_msg``), key traits and addresses
(``utils/address.py``) against the JAX package's host functions, on the
CPU, on the vectors of tests/test_primitives.py, tests/test_batch_verify.py
and tests/test_transaction.py: under the same SeededRng the signatures and
addresses are equal byte for byte; ``Signature.batch_verify`` accepts
honest batches and rejects a poisoned one on "host" and on "device" (the
MSM's plain versions with ``device="cpu"``); the default device and the
"sharded" backend raise. Everything is exact."""

import pytest
import torch

from quisquis_tpu.accounts.transcript import SeededRng as JaxSeededRng
from quisquis_tpu.accounts.transcript import Transcript as JaxTranscript
from quisquis_tpu.primitives import schnorr as jschnorr
from quisquis_tpu.primitives.keys import RistrettoPublicKey as JaxPk
from quisquis_tpu.primitives.keys import RistrettoSecretKey as JaxSk
from quisquis_tpu.utils import address as jaddress
from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
from quisquis_tpu_torch.ops import exact as ex
from quisquis_tpu_torch.primitives import schnorr, traits
from quisquis_tpu_torch.primitives.keys import RistrettoPublicKey, RistrettoSecretKey
from quisquis_tpu_torch.primitives.schnorr import Signature, VerificationKey
from quisquis_tpu_torch.utils import address

PORT = (RistrettoSecretKey, RistrettoPublicKey, SeededRng)
JAX = (JaxSk, JaxPk, JaxSeededRng)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here, and in the processes that this module starts."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(prev)


def _keypair(side, tag: bytes):
    sk_cls, pk_cls, rng_cls = side
    r = rng_cls(seed=tag)
    sk = sk_cls.random(r)
    return sk, pk_cls.from_secret_key(sk, r), r


def test_sign_msg_equals_jax_and_verifies():
    """tests/test_primitives.py::test_signature's vector."""
    msg = b"This is a signing message"
    sk, pk, r = _keypair(PORT, b"test")
    jsk, jpk, jr = _keypair(JAX, b"test")
    sig = pk.sign_msg(msg, sk, b"valueSign", rng=r)
    jsig = jpk.sign_msg(msg, jsk, b"valueSign", rng=jr)
    assert sig.to_bytes() == jsig.to_bytes()
    pk.verify_msg(msg, sig, b"valueSign")
    pk.verify_msg(msg, Signature.from_bytes(jsig.to_bytes()), b"valueSign")
    jpk.verify_msg(msg, jschnorr.Signature.from_bytes(sig.to_bytes()), b"valueSign")
    with pytest.raises(ValueError):
        pk.verify_msg(b"other message", sig, b"valueSign")
    with pytest.raises(ValueError):
        pk.verify_msg(msg, sig, b"otherLabel")
    assert isinstance(sk, traits.SecretKey) and isinstance(pk, traits.PublicKey)


def test_reference_vector_equals_jax():
    """tests/test_primitives.py::test_signature_reference_vectors
    (signature.rs:187-209): privkey 1, r 10987."""
    privkey, rr = 1, 10987
    X = VerificationKey.from_secret(privkey, rr)
    jX = jschnorr.VerificationKey.from_secret(privkey, rr)
    assert X.to_bytes() == jX.to_bytes()
    sig = Signature.sign(Transcript(b"example transcript"), X, privkey,
                         rng=SeededRng(seed=b"test"))
    jsig = jschnorr.Signature.sign(JaxTranscript(b"example transcript"), jX, privkey,
                                   rng=JaxSeededRng(seed=b"test"))
    assert sig.to_bytes() == jsig.to_bytes()
    sig.verify(Transcript(b"example transcript"), X)
    with pytest.raises(ValueError):
        sig.verify(Transcript(b"example transcript"), VerificationKey.from_secret(2, rr))
    with pytest.raises(ValueError):
        sig.verify(Transcript(b"invalid transcript"), X)


def _batch(side_schnorr, rng_cls, transcript_cls, count=8):
    """tests/test_batch_verify.py::test_schnorr_batch_verify's items."""
    r = rng_cls(seed=b"schnorrbatch")
    items = []
    for i in range(count):
        sk = r.random_scalar()
        vk = side_schnorr.VerificationKey.from_secret(sk, r.random_scalar())
        t = transcript_cls(b"sig%d" % i)
        items.append((side_schnorr.Signature.sign(t.clone(), vk, sk, rng=r), t, vk))
    return items


@pytest.mark.parametrize("backend", ["host", "device"])
def test_batch_verify_accepts_honest_rejects_poisoned(backend):
    items = _batch(schnorr, SeededRng, Transcript)
    jitems = _batch(jschnorr, JaxSeededRng, JaxTranscript)
    assert [s.to_bytes() for s, _, _ in items] == [s.to_bytes() for s, _, _ in jitems]
    Signature.batch_verify([(s, t.clone(), v) for s, t, v in items], backend=backend,
                           seed=b"w", device="cpu")
    bad = Signature((items[0][0].s + 1) % ex.L, items[0][0].R)
    poisoned = [(bad, items[0][1].clone(), items[0][2])] + \
        [(s, t.clone(), v) for s, t, v in items[1:]]
    with pytest.raises(ValueError):
        Signature.batch_verify(poisoned, backend=backend, seed=b"w", device="cpu")


def test_batch_verify_default_device_and_sharded_raise():
    items = _batch(schnorr, SeededRng, Transcript, count=2)

    def fresh():
        return [(s, t.clone(), v) for s, t, v in items]

    with pytest.raises(ValueError, match="sharded backend requires a mesh"):
        Signature.batch_verify(fresh(), backend="sharded", device="cpu")
    # as in the JAX package, only the sharded backend reads a mesh
    Signature.batch_verify(fresh(), mesh=object(), device="cpu")
    if torch.cuda.is_available():
        return
    for backend in ("auto", "device"):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            Signature.batch_verify(items, backend=backend)


def test_address_equals_jax_and_roundtrips():
    """tests/test_transaction.py::test_address_roundtrip's vector."""
    _, pk, _ = _keypair(PORT, b"addr")
    _, jpk, _ = _keypair(JAX, b"addr")
    assert pk.as_bytes() == jpk.as_bytes()
    for net, jnet in ((address.Network.Mainnet, jaddress.Network.Mainnet),
                      (address.Network.Testnet, jaddress.Network.Testnet)):
        for kind in ("standard", "contract"):
            addr = getattr(address.Address, kind)(net, pk)
            jaddr = getattr(jaddress.Address, kind)(jnet, jpk)
            b = addr.as_bytes()
            assert len(b) == 69 and b == jaddr.as_bytes()
            assert addr.as_hex() == jaddr.as_hex()
            assert addr.as_base58() == jaddr.as_base58()
            assert address.Address.from_bytes(jaddr.as_bytes()) == addr
            assert address.Address.from_hex(addr.as_hex()) == addr
            assert address.Address.from_base58(jaddr.as_base58()) == addr
    assert address.Address.from_bytes(
        address.Address.contract(address.Network.Testnet, pk).as_bytes()
    ).addr_type == address.AddressType.Contract
    bad = bytearray(addr.as_bytes())
    bad[-1] ^= 1
    with pytest.raises(ValueError):
        address.Address.from_bytes(bytes(bad))
    with pytest.raises(ValueError):
        address.Address.from_bytes(b[:68])
    assert address.b58_encode(b"\x00\x00\x01") == jaddress.b58_encode(b"\x00\x00\x01")
    assert address.b58_decode("11" + address.b58_encode(b"\x05")) == b"\x00\x00\x05"
