"""Inputs repeat by seed; the reference accepts the honest transactions and
rejects each tampered copy, at a small size."""

import pytest

from qqbench import gen

CFG9 = {"name": "test-n9", "anonymity_set_size": 9, "senders": 1}
CFG4X4 = {"name": "test-4x4-n9", "anonymity_set_size": 9, "senders": 4}
VERIFY = {"transactions": 4, "tampered": list(gen.TAMPER_KINDS)}
BUILD = {"request_sets": 2, "requests_per_call": 2}
SEED = 2 ** 31 + 977


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
