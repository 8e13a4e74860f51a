"""Inputs repeat by seed; the reference accepts the honest transactions and
shuffle proofs and rejects each tampered copy, at a small size; the two
transaction entries send what they sent before entries were files, byte for
byte."""

import hashlib

import pytest

from qqbench import entries, gen
from qqbench.entries import verify_shuffle_wire as shuffle_entry

CFG9 = {"name": "test-n9", "anonymity_set_size": 9, "senders": 1}
CFG4X4 = {"name": "test-4x4-n9", "anonymity_set_size": 9, "senders": 4}
VERIFY = {"transactions": 4, "tampered": list(gen.TAMPER_KINDS)}
BUILD = {"request_sets": 2, "requests_per_call": 2}
SEED = 2 ** 31 + 977
CFG_SHUFFLE = {"name": "test-shuffle-n9", "anonymity_set_size": 9, "proof_label": "Shuffle",
               "transcript_label": "ShuffleProof"}
SHUFFLE = {"proofs": 4, "tampered": list(shuffle_entry.TAMPER_KINDS)}
#: the canonical digest (:func:`digest`) of the inputs above, as the harness
#: made them before its entries became files of their own (a commit whose
#: qqbench/entries.py held both entries); a change of the generator that
#: changes what a cell sends changes these
PINNED = {"verify_wire": "9e84d034ae9dee46fb9e02800b0762706a7292819d146886342662ad0810ea90",
          "build": "5af3f5b5716a24b162fd866a4db6fd6997f3dc1ea38348b33d761155ee1c753c"}


def _canon(x, h) -> None:
    if isinstance(x, dict):
        h.update(b"d%d" % len(x))
        for k in sorted(x):
            _canon(k, h)
            _canon(x[k], h)
    elif isinstance(x, (list, tuple)):
        h.update(b"l%d" % len(x))
        for v in x:
            _canon(v, h)
    elif isinstance(x, bool):
        h.update(b"b%d" % x)
    elif isinstance(x, int):
        h.update(b"i%d;" % x)
    elif isinstance(x, bytes):
        h.update(b"y%d:" % len(x) + x)
    elif isinstance(x, str):
        h.update(b"s%d:" % len(x.encode()) + x.encode())
    else:
        raise TypeError(type(x))


def digest(data) -> str:
    """sha256 of a canonical encoding of nested dicts, lists, bytes, ints,
    bools and strings (independent of pickle's framing)."""
    h = hashlib.sha256()
    _canon(data, h)
    return h.hexdigest()


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(gen, "cache_dir", lambda: tmp_path)
    return tmp_path


@pytest.fixture(scope="module")
def verify_data(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(gen, "cache_dir", lambda: tmp_path_factory.mktemp("cache"))
    try:
        data, made_s = gen.verify_inputs(CFG9, VERIFY, SEED, workers=2)
    finally:
        mp.undo()
    assert made_s > 0
    return data


def test_the_reference_accepts_the_honest_and_rejects_each_tampering(verify_data):
    assert verify_data["verdicts"] == [True] * VERIFY["transactions"]
    assert set(verify_data["tampered"]) == set(gen.TAMPER_KINDS)
    assert verify_data["tampered_verdicts"] == {k: False for k in gen.TAMPER_KINDS}
    t = verify_data["tampered_index"]
    for kind, (txb, pfb) in verify_data["tampered"].items():
        honest = verify_data["pairs"][t]
        assert txb == honest[0] and pfb != honest[1] and len(pfb) == len(honest[1])


def test_verify_inputs_repeat_by_seed(verify_data, fresh_cache):
    again, made_s = gen.verify_inputs(CFG9, VERIFY, SEED, workers=2)
    assert made_s > 0   # made anew in an empty cache, not read back
    assert again["pairs"] == verify_data["pairs"]
    assert again["tampered"] == verify_data["tampered"]
    other, _ = gen.verify_inputs(CFG9, VERIFY, SEED + 1, workers=2)
    assert not set(other["pairs"]) & set(verify_data["pairs"])


def test_a_cached_run_reads_the_inputs_back(fresh_cache):
    first, made_s = gen.build_inputs(CFG4X4, BUILD, SEED, workers=2)
    second, again_s = gen.build_inputs(CFG4X4, BUILD, SEED, workers=2)
    assert made_s > 0 and again_s == 0.0 and first == second
    assert len(first) == 2 and all(len(s) == 2 for s in first)
    assert first[0][0]["senders_count"] == 4 and len(first[0][0]["account_vector"]) == 9


def test_build_inputs_repeat_by_seed_and_the_reference_builds_repeat(fresh_cache, tmp_path_factory):
    a, _ = gen.build_inputs(CFG4X4, BUILD, SEED, workers=2)
    ra = gen.reference_builds(CFG4X4, BUILD, SEED, [0], a, workers=2)
    gen.cache_dir = lambda: tmp_path_factory.mktemp("other")   # undone by monkeypatch
    b, made_s = gen.build_inputs(CFG4X4, BUILD, SEED, workers=2)
    assert made_s > 0 and a == b
    rb = gen.reference_builds(CFG4X4, BUILD, SEED, [0], b, workers=2)
    assert ra == rb and len(ra[0]) == 2
    c, _ = gen.build_inputs(CFG4X4, BUILD, SEED + 1, workers=2)
    assert c[0][0]["account_vector"] != a[0][0]["account_vector"]


@pytest.mark.parametrize("name,config,mix", [("verify_wire", CFG9, VERIFY),
                                             ("build", CFG4X4, BUILD)])
def test_the_inputs_equal_the_parents_byte_for_byte(fresh_cache, monkeypatch, name, config, mix):
    monkeypatch.setattr(gen, "POOL_WORKERS", 2)
    cls = entries.load(name)
    data, made_s = gen.verify_inputs(config, mix, SEED, workers=2) if name == "verify_wire" \
        else gen.build_inputs(config, mix, SEED, workers=2)
    assert made_s > 0 and digest(data) == PINNED[name]
    # the entry's own generator reads the same back from the cache
    again, again_s = cls.inputs(config, mix, SEED)
    assert again_s == 0.0 and digest(again) == PINNED[name]


@pytest.fixture(scope="module")
def shuffle_data(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(gen, "cache_dir", lambda: tmp_path_factory.mktemp("cache"))
    try:
        data, made_s = shuffle_entry.shuffle_inputs(CFG_SHUFFLE, SHUFFLE, SEED, workers=2)
    finally:
        mp.undo()
    assert made_s > 0
    return data


def test_the_reference_accepts_the_honest_proofs_and_rejects_each_tampering(shuffle_data):
    assert shuffle_data["verdicts"] == [True] * SHUFFLE["proofs"]
    assert shuffle_data["tampered_verdicts"] == {k: False for k in shuffle_entry.TAMPER_KINDS}
    honest = shuffle_data["entries"][shuffle_data["tampered_index"]]
    for blob in shuffle_data["tampered"].values():
        assert blob != honest and len(blob) == len(honest)
    assert len(set(shuffle_data["entries"])) == SHUFFLE["proofs"]


def test_shuffle_inputs_repeat_by_seed(shuffle_data, fresh_cache):
    again, made_s = shuffle_entry.shuffle_inputs(CFG_SHUFFLE, SHUFFLE, SEED, workers=2)
    assert made_s > 0 and digest(again) == digest(shuffle_data)
    other, _ = shuffle_entry.shuffle_inputs(CFG_SHUFFLE, SHUFFLE, SEED + 1, workers=2)
    assert not set(other["entries"]) & set(shuffle_data["entries"])


def test_the_reference_wire_entry_is_the_ports(shuffle_data):
    """The reference's shuffle entry bytes read back into the port's objects
    and out again unchanged."""
    from quisquis_tpu_torch.utils import serde

    for blob in shuffle_data["entries"][:2] + list(shuffle_data["tampered"].values()):
        assert serde.shuffle_entry_to_bytes(*serde.shuffle_entry_from_bytes(blob)) == blob


def test_inputs_that_the_reference_contradicts_are_refused(fresh_cache, monkeypatch):
    monkeypatch.setattr(shuffle_entry, "tamper", lambda blob, kind: blob)
    with pytest.raises(RuntimeError, match="accepted a tampered one"):
        shuffle_entry.shuffle_inputs(CFG_SHUFFLE, dict(SHUFFLE, proofs=2), SEED, workers=2)


def test_a_cache_key_hashes_the_generator_and_its_own_entry_only(monkeypatch):
    """Adding or changing one entry's file re-makes that entry's inputs
    alone: the key of the transaction inputs reads no entry's file, and the
    shuffle entry's reads its own besides."""
    from pathlib import Path

    from qqbench.paths import PKG

    read, real = [], Path.read_bytes
    monkeypatch.setattr(Path, "read_bytes", lambda p: read.append(p) or real(p))
    gen.generator_hash()
    plain = set(read)
    read.clear()
    own = Path(shuffle_entry.__file__)
    gen.generator_hash(own)
    assert set(read) - plain == {own} and PKG / "gen.py" in plain
    assert not any(p.parent == entries.DIR for p in plain)
