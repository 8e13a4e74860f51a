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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here, and in the processes that this module starts."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(prev)


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


def _port_shuffles(tag: bytes, m: int, count: int):
    """(proof, statement, inputs, outputs) per proof from the port's host
    prover (no JAX on a GPU machine)."""
    from quisquis_tpu_torch.accounts.accounts import Account
    from quisquis_tpu_torch.accounts.prover import Prover
    from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
    from quisquis_tpu_torch.primitives.keys import RistrettoPublicKey, RistrettoSecretKey
    from quisquis_tpu_torch.shuffle.shuffle import Shuffle, ShuffleProof
    rng = SeededRng(seed=tag)
    accounts = [Account.generate_account(
        RistrettoPublicKey.from_secret_key(RistrettoSecretKey.random(rng), rng), rng)[0]
        for _ in range(m * m)]
    out = []
    for _ in range(count):
        sh = Shuffle.input_shuffle(accounts, rng=rng)
        proof, st = ShuffleProof.create_shuffle_proof(
            Prover(b"Shuffle", Transcript(b"ShuffleProof"), rng=rng), sh, rng=rng)
        out.append((proof, st, sh.get_inputs_vector(), sh.get_outputs_vector()))
    return out


def test_shuffle_verifier_accepts_and_rejects(dev):
    import dataclasses
    from quisquis_tpu_torch.accounts.transcript import SeededRng
    from quisquis_tpu_torch.shuffle.device_verify import DeviceShuffleVerifier
    entries = _port_shuffles(b"cuda-shuffle", 3, 4)
    dsv = DeviceShuffleVerifier(3, 4)
    before = dict(kp.LAUNCHES)
    dsv.verify(entries, rng=SeededRng(seed=b"w"))
    ran = {k: kp.LAUNCHES[k] - before[k] for k in kp.LAUNCHES}
    assert ran["scalar_mul"] == 1 and ran["base_mul"] == 0 and ran["keccak_f1600"] > 0
    assert ran["msm_table"] == ran["msm_acc"] == ran["msm_tail"] == 2
    p, st, ins, outs = entries[2]
    bad = list(entries)
    bad[2] = (dataclasses.replace(p, hadamard_proof=dataclasses.replace(
        p.hadamard_proof, a_bar=[p.hadamard_proof.a_bar[0] + 1] + p.hadamard_proof.a_bar[1:])),
        st, ins, outs)
    with pytest.raises(ValueError):
        dsv.verify(bad, rng=SeededRng(seed=b"w"))


def test_sigma_device_functions_equal_host(dev):
    from quisquis_tpu_torch.accounts import device_verifier as dvf
    from quisquis_tpu_torch.accounts.accounts import Account
    from quisquis_tpu_torch.accounts.prover import Prover
    from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
    from quisquis_tpu_torch.accounts.verifier import Verifier
    from quisquis_tpu_torch.primitives.keys import RistrettoPublicKey
    rng = SeededRng(seed=b"cuda-sigma")
    accounts, rs = [], []
    for _ in range(16):
        acc, r = Account.generate_account(
            RistrettoPublicKey.update_public_key(RistrettoPublicKey.generate_base_pk(),
                                                 rng.random_scalar()), rng)
        accounts.append(acc)
        rs.append(r)
    z, x = Prover.zero_balance_account_vector_prover(
        accounts, rs, Prover(b"DLOGProof", Transcript(b"ZB"), rng=rng)).get_dlog()
    for fn in (dvf.zero_balance_account_vector_verifier_device,
               Verifier.zero_balance_account_vector_verifier):
        fn(accounts, z, x, Verifier(b"DLOGProof", Transcript(b"ZB")))
    assert (dvf.zero_balance_encodings(accounts, z, x)
            == dvf.zero_balance_encodings(accounts, z, x, device="cpu")).all()
    values = [(-5) % ex.L, 5] + [0] * 14
    delta, eps, rsc = Account.create_delta_and_epsilon_accounts(
        accounts, values, RistrettoPublicKey.generate_base_pk(), rng)
    zv, zr1, zr2, x = Prover.verify_delta_compact_prover(
        delta, eps, rsc, values, Prover(b"DLEQProof", Transcript(b"DC"), rng=rng)).get_dleq()
    before = dict(kp.LAUNCHES)
    dvf.verify_delta_compact_verifier_device(delta, eps, zv, zr1, zr2, x,
                                             Verifier(b"DLEQProof", Transcript(b"DC")))
    assert kp.LAUNCHES["scalar_mul"] == before["scalar_mul"] + 1
    assert kp.LAUNCHES["base_mul"] == before["base_mul"] + 1
    with pytest.raises(ValueError):
        dvf.verify_delta_compact_verifier_device(delta, eps, [(zv[0] + 1) % ex.L] + zv[1:], zr1,
                                                 zr2, x, Verifier(b"DLEQProof", Transcript(b"DC")))
    assert (dvf.delta_compact_encodings(delta, eps, zv, zr1, zr2, x)
            == dvf.delta_compact_encodings(delta, eps, zv, zr1, zr2, x, device="cpu")).all()


def test_deferred_device_equals_host(dev):
    from quisquis_tpu_torch.accounts.deferred import DeferredPointChecks
    r = random.Random(11)
    pts = [ex.pt_base_mul(r.randrange(ex.L)) for _ in range(300)]
    for bad in (False, True):
        verdicts = []
        for backend in ("host", "device"):
            checks = DeferredPointChecks(b"cuda-deferred")
            for i in range(0, 300, 3):
                a, b = r.randrange(1, ex.L), r.randrange(1, ex.L)
                s = ex.pt_add(ex.pt_mul(a, pts[i]), ex.pt_mul(b, pts[i + 1]))
                checks.check_eq([a, b + (bad and i == 150)], pts[i:i + 2], s, f"row {i}")
            try:
                checks.verify(backend=backend)
                verdicts.append(True)
            except ValueError:
                verdicts.append(False)
        assert verdicts == [not bad, not bad]


def test_shuffle_path_shapes_equal_plain(dev):
    """scalar_mul over the B (3m + 3) product lanes and msm_rows over the
    [6B, N + 1] statement rows of the m = 8, B = 16 shuffle verifier."""
    m, B = 8, 16
    lanes, rows, k = B * (3 * m + 3), 6 * B, m * m + 1
    nib = torch.as_tensor(pt.scalars_to_nibbles(_scalars(lanes + rows * k)), device=dev)
    p = kp.base_mul(nib.flip(0).contiguous())
    got = kp.scalar_mul(nib[:lanes], pt.ExtPoint(*(c[:lanes] for c in p)))
    want = pt.scalar_mul(nib[:lanes], pt.ExtPoint(*(c[:lanes] for c in p)))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    nib_rk = nib[lanes:].reshape(rows, k, 64)
    p_rk = pt.ExtPoint(*(c[lanes:].reshape(rows, k, fe.NLIMBS) for c in p))
    digits, flat = kp.pad_rows(nib_rk, p_rk)
    plain = qmsm.msm_tail(qmsm.msm_window_sums(digits, qmsm.msm_table(flat), rows))
    assert all(torch.equal(a, b) for a, b in zip(kp.msm_rows(nib_rk, p_rk), plain))


def _range_lanes(tag: bytes, m: int, count: int):
    from quisquis_tpu_torch.accounts.transcript import SeededRng
    out = []
    for i in range(count):
        rng = SeededRng(seed=tag + b"%d" % i)
        out.append(([int.from_bytes(rng.fill_bytes(1), "little") for _ in range(m)],
                    [rng.random_scalar() for _ in range(m)], rng))
    return out


def test_range_prover_equals_host_bytes(dev):
    """DeviceRangeProver(n = 8, m = 2, B = 4) on the card: byte-identical to
    the host prover under the same streams, through the MSM and Keccak
    kernels; the basis tables are built by the first prove only."""
    from quisquis_tpu_torch.accounts.transcript import Transcript
    from quisquis_tpu_torch.bulletproofs.device_prove import DeviceRangeProver
    from quisquis_tpu_torch.bulletproofs.range_proof import RangeProof
    n, m, B = 8, 2, 4
    want = [RangeProof.prove_multiple(Transcript(b"RangeProof"), v, b, n, rng=r)
            for v, b, r in _range_lanes(b"cuda-range", m, B)]
    drp = DeviceRangeProver(n, m, B)
    for _ in range(2):
        before = dict(kp.LAUNCHES)
        lanes = _range_lanes(b"cuda-range", m, B)
        proofs, vlists = drp.prove(*(list(x) for x in zip(*lanes)))
        ran = {k: kp.LAUNCHES[k] - before[k] for k in kp.LAUNCHES}
        assert [p.to_bytes() for p in proofs] == [p.to_bytes() for p, _ in want]
        assert vlists == [list(v) for _, v in want]
        assert ran["msm_acc"] == ran["msm_tail"] == 2 + drp.k and ran["keccak_f1600"] > 0
    assert ran["msm_table"] == 0  # the cached tables


def test_shuffle_prover_equals_host(dev):
    """DeviceShuffleProver(m = 3, B = 4) on the card: proofs and statements
    equal the host prover's under the same streams."""
    import copy
    from quisquis_tpu_torch.accounts.accounts import Account
    from quisquis_tpu_torch.accounts.prover import Prover
    from quisquis_tpu_torch.accounts.transcript import SeededRng, Transcript
    from quisquis_tpu_torch.primitives.keys import RistrettoPublicKey, RistrettoSecretKey
    from quisquis_tpu_torch.shuffle.device_prove import DeviceShuffleProver
    from quisquis_tpu_torch.shuffle.shuffle import Shuffle, ShuffleProof
    m, B = 3, 4
    rng = SeededRng(seed=b"cuda-shuffle-prove")
    accounts = [Account.generate_account(RistrettoPublicKey.from_secret_key(
        RistrettoSecretKey.random(rng), rng), rng)[0] for _ in range(m * m)]
    shuffles, rngs, want = [], [], []
    for i in range(B):
        r = SeededRng(seed=b"cuda-shuffle-prove-%d" % i)
        sh = Shuffle.input_shuffle(accounts, rng=r)
        shuffles.append(sh)
        rngs.append(copy.deepcopy(r))
        want.append(ShuffleProof.create_shuffle_proof(
            Prover(b"Shuffle", Transcript(b"ShuffleProof"), rng=r), sh, rng=r))
    before = dict(kp.LAUNCHES)
    got = DeviceShuffleProver(m, B).prove(shuffles, rngs)
    ran = {k: kp.LAUNCHES[k] - before[k] for k in kp.LAUNCHES}
    assert got == want
    assert all(ran[k] > 0 for k in ("msm_table", "msm_acc", "msm_tail", "keccak_f1600"))


@pytest.mark.parametrize("rows, k", [(16, 34), (8, 2), (24, 4), (96, 2050)])
def test_shared_rows_equal_plain(dev, rows, k):
    """msm_shared_rows at the provers' shapes: the range prover's V/A/S
    rows at n = 8, m = 2, B = 4 (16 x 34), its T rows (8 x 2), the shuffle
    prover's commitments at m = 3, B = 4 (24 x 4), and 96 rows over the
    (64, 16) basis of 2,050 points. Against the plain version as points,
    and each kernel stage against its plain stage limb for limb on the
    tiled inputs."""
    nib = torch.as_tensor(pt.scalars_to_nibbles(_scalars(rows * k)), device=dev)
    nib = nib.reshape(rows, k, 64)
    basis_nib = torch.as_tensor(pt.scalars_to_nibbles(_scalars(k + 9)[1:k + 1]), device=dev)
    basis = kp.SharedBasis(kp.base_mul(basis_nib))
    before = dict(kp.LAUNCHES)
    got = kp.msm_shared_rows(nib, basis)
    kp.msm_shared_rows(nib, basis)
    ran = {k_: kp.LAUNCHES[k_] - before[k_] for k_ in kp.LAUNCHES}
    assert ran["msm_table"] == 1 and ran["msm_acc"] == ran["msm_tail"] == 2
    cpu_basis = kp.SharedBasis(pt.ExtPoint(*(c.cpu() for c in basis.points)))
    if rows * k <= 1000:
        want = kp.msm_shared_rows(nib.cpu(), cpu_basis)
        assert (pt.compress_to_bytes(got) == pt.compress_to_bytes(want)).all()
    table = basis.table()
    kpad = table.x.shape[-1]
    digits = torch.cat([nib, nib.new_zeros((rows, kpad - k, 64))], 1).reshape(-1, 64).t()
    digits = digits.contiguous()
    tiled = pt.ExtPoint(*(c[:, :, None, :].expand(16, fe.NLIMBS, rows, kpad)
                          .reshape(16, fe.NLIMBS, rows * kpad) for c in table))
    flat = pt.ExtPoint(*(torch.cat([c, e]) for c, e in
                         zip(basis.points, pt.identity((kpad - k,), dev))))
    assert all(torch.equal(a, b) for a, b in zip(table, qmsm.msm_table(flat)))
    sums = kp.msm_window_sums(digits, tiled, rows)
    part = slice(0, min(rows, 8))  # the plain stage on the first rows
    n_part = (part.stop - part.start) * kpad
    plain_sums = qmsm.msm_window_sums(digits[:, :n_part].contiguous(),
                                      pt.ExtPoint(*(c[..., :n_part] for c in tiled)),
                                      part.stop)
    assert all(torch.equal(a[part], b) for a, b in zip(sums, plain_sums))
    out = kp.msm_tail(sums)
    assert all(torch.equal(a, b) for a, b in zip(out, got))
    assert all(torch.equal(a[part], b) for a, b in zip(out, qmsm.msm_tail(
        pt.ExtPoint(*(c[part] for c in sums)))))
    # and against the exact backend on two rows
    host_pts = pt.to_exact_batch(basis.points)
    for r in (0, rows - 1):
        s = [sum(int(d) << (4 * w) for w, d in enumerate(row)) for row in nib[r].tolist()]
        assert bytes(pt.compress_to_bytes(got)[r]) == ex.ristretto_encode(ex.pt_msm(s, host_pts))


def test_batch_create_transactions_equals_the_host_loop(dev):
    """Three 1 + 1 transactions over 9 accounts, their range proofs as a
    bucket of 4 lanes of the device prover: byte for byte the loop of
    create_transaction, launches on the card."""
    from quisquis_tpu_torch.bulletproofs import device_prove as rdp
    from quisquis_tpu_torch.transaction import transaction as ptx
    from quisquis_tpu_torch.transaction.workloads import benchmark_requests, comparable
    rdp._PROVER_CACHE.clear()
    before = dict(kp.LAUNCHES)
    built = ptx.batch_create_transactions(benchmark_requests(b"cuda-tx", 3, 1, 9),
                                          range_backend="device-batched", device=dev)
    assert [k[:3] for k in rdp._PROVER_CACHE] == [(64, 2, 4)]
    assert all(kp.LAUNCHES[k] > before[k] for k in ("msm_acc", "msm_tail", "keccak_f1600"))
    loop = [ptx.create_transaction(**req) for req in benchmark_requests(b"cuda-tx", 3, 1, 9)]
    assert comparable(built) == comparable(loop)


def test_batch_verify_transactions_device_batched(dev):
    """The device-batched verdict on an honest batch and on one tampered
    transaction: a multi-exponentiation commitment of its output shuffle,
    which only the device verifier reads."""
    import dataclasses
    from quisquis_tpu_torch.transaction import transaction as ptx
    from quisquis_tpu_torch.transaction.workloads import benchmark_requests
    items = ptx.batch_create_transactions(benchmark_requests(b"cuda-tv", 3, 1, 9),
                                          range_backend="host")
    before = dict(kp.LAUNCHES)
    ptx.batch_verify_transactions(items, backend="device-batched", seed=b"w", device=dev)
    assert all(kp.LAUNCHES[k] > before[k] for k in kp.LAUNCHES if k != "base_mul")
    tx, proof = items[1]
    sp = proof.output_shuffle_proof
    me = sp.multi_exponen_commit
    me = dataclasses.replace(me, E_k_0=[bytes([me.E_k_0[0][0] ^ 1]) + me.E_k_0[0][1:]]
                             + me.E_k_0[1:])
    bad = dataclasses.replace(proof, output_shuffle_proof=dataclasses.replace(
        sp, multi_exponen_commit=me))
    for backend in ("device-batched", "host"):
        with pytest.raises(ValueError):
            ptx.batch_verify_transactions([items[0], (tx, bad), items[2]], backend=backend,
                                          seed=b"w", device=dev)
