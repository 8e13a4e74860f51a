#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (quisquis_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. require a CUDA GPU; print its name and power limit (nvidia-smi);
  2. build the two CUDA kernels from csrc/ (nvcc, at first use);
  3. hold each kernel against its plain PyTorch version on the card at
     B = 256 (edge scalars included), and 8 rows against the exact backend;
  4. the main path at N = 16,384 accounts: keys made on the card, the
     flagship step (generate + verify commitments), update_accounts, then
     verify_commitments and verify_keypairs on the updated state; one
     tampered lane must fail alone; 32 sampled lanes against exact.py;
  5. the Account-object path on 1,024 Accounts built from phase 4's wire
     bytes: update_accounts_device and delta/epsilon creation, 16 rows
     byte-identical to the host Account methods;
  6. each kernel's phase-4 output at N = 16,384, and a launch on its first
     1,024 lanes (phase 5's width), limb for limb against the plain version
     on the same inputs; times on this card: each kernel and its plain
     version at N = 16,384, end-to-end account updates per second;
  7. one JSON line per contract with every kernel's numbers, then the
     final status line.

Any failed check raises, and the script exits non-zero. It also exits
non-zero without a GPU or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
N_MAIN = 16_384
B_CHECK = 256
N_ACCOUNTS = 1_024
MEM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet
INT32_LANES_PER_SM = 64     # Hopper SM: 4 partitions x 16 INT32 lanes
# 32x32->64 limb products of one field multiply and one square
# (csrc/field25519.cuh fe_mul, fe_sq), and their counts per lane (csrc notes)
PRODUCTS = {"fe_mul": 100, "fe_sq": 55}
FIELD_OPS = {"scalar_mul": {"fe_mul": 1477, "fe_sq": 1036},
             "base_mul": {"fe_mul": 448, "fe_sq": 0}}
KERNELS = {
    "scalar_mul": ("quisquis_tpu_torch/csrc/scalar_mul.cu", "quisquis_tpu/ops/pallas_point.py:79"),
    "base_mul": ("quisquis_tpu_torch/csrc/base_mul.cu", "quisquis_tpu/ops/pallas_point.py:212"),
}


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def say(phase, msg: str) -> None:
    print(f"phase {phase}: {msg}", flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn over reps runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_once(fn):
    """fn's output and its device time in ms, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def profile_line(fn, card: str) -> str:
    """Device time by kernel and the device's busy share over one call of
    fn, from torch.profiler's kernel events (wall time on the host clock,
    with the profiler's own overhead)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return "torch.profiler recorded no device kernels: busy share not measured"
    by_name = {"scalar_mul_kernel": 0.0, "base_mul_kernel": 0.0, "torch ops": 0.0}
    spans = []
    for e in kernels:
        key = next((k for k in by_name if k in e.name), "torch ops")
        by_name[key] += e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    parts = ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in by_name.items())
    return (f"profiled update_accounts: {len(kernels)} kernels; {parts}; device busy "
            f"{busy / 1e3:.3f} of {wall_us / 1e3:.3f} ms wall = {busy / wall_us:.3f} "
            f"(idle {1 - busy / wall_us:.3f}) [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from quisquis_tpu_torch.accounts.accounts import Account
    from quisquis_tpu_torch.accounts.device_accounts import (
        create_delta_and_epsilon_accounts_device, update_accounts_device)
    from quisquis_tpu_torch.accounts.transcript import SeededRng
    from quisquis_tpu_torch.ops import batch as qb
    from quisquis_tpu_torch.ops import cuda_point as kp
    from quisquis_tpu_torch.ops import exact as ex
    from quisquis_tpu_torch.ops import field as fe
    from quisquis_tpu_torch.ops import point as pt
    from quisquis_tpu_torch.primitives.elgamal import ElGamalCommitment
    from quisquis_tpu_torch.primitives.keys import RistrettoPublicKey

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    # -- phase 1 --------------------------------------------------------
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    int32_peak = sms * INT32_LANES_PER_SM * max_sm_mhz * 1e6
    say(1, f"device {kind} x{torch.cuda.device_count()}; {sms} SMs, max SM clock "
           f"{max_sm_mhz} MHz; torch {torch.__version__} CUDA {torch.version.cuda}")

    # -- phase 2 --------------------------------------------------------
    kp.load_library()
    say(2, f"kernels built or loaded in {kp.build_seconds():.1f} s")
    for line in kp.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip(), flush=True)

    def scalar_bytes(n):  # uniform below 2^252 < l
        b = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
        b[:, 31] &= 0x0F
        return b

    def small_bytes(n, nbytes=4):  # values < 2^32
        b = np.zeros((n, 32), dtype=np.uint8)
        b[:, :nbytes] = rng.integers(0, 256, size=(n, nbytes), dtype=np.uint8)
        return b

    def nib_of(b):
        return torch.as_tensor(pt.scalar_to_nibbles(b), device=dev)

    def ints_of(b, rows):
        return [int.from_bytes(bytes(b[i]), "little") for i in rows]

    def canon_err(a: pt.ExtPoint, b: pt.ExtPoint) -> int:
        return max(int((fe.canonicalize(x).long() - fe.canonicalize(y).long()).abs().max())
                   for x, y in zip(a, b))

    def limb_err(a: pt.ExtPoint, b: pt.ExtPoint) -> int:
        return max(int((x.long() - y.long()).abs().max()) for x, y in zip(a, b))

    # -- phase 3: each kernel against its plain version -------------------
    many15 = int("f" * 63, 16) % ex.L
    edge = [0, 1, ex.L - 1, 2**252, many15, 15, 16, 2**252 - 1]
    check_b = scalar_bytes(B_CHECK)
    for i, s in enumerate(edge):
        check_b[i] = np.frombuffer(ex.sc_to_bytes(s), dtype=np.uint8)
    nib3 = nib_of(check_b)
    base3 = pt.base_mul(nib_of(scalar_bytes(B_CHECK)))  # plain torch on the card
    err = {}
    k_out = kp.scalar_mul(nib3, base3)
    p_out = pt.scalar_mul(nib3, base3)
    err["scalar_mul"] = canon_err(k_out, p_out)
    check(pt.compress_to_bytes(k_out).tobytes() == pt.compress_to_bytes(p_out).tobytes(),
          "scalar_mul kernel == plain at canonical encodings")
    host_pts = pt.to_exact_batch(pt.ExtPoint(*(c[:8] for c in base3)))
    k_enc = pt.compress_to_bytes(pt.ExtPoint(*(c[:8] for c in k_out)))
    for i, s in enumerate(ints_of(check_b, range(8))):
        check(bytes(k_enc[i]) == ex.ristretto_encode(ex.pt_mul(s, host_pts[i])),
              f"scalar_mul row {i} == exact")
    k_out = kp.base_mul(nib3)
    p_out = pt.base_mul(nib3)
    err["base_mul"] = canon_err(k_out, p_out)
    check(pt.compress_to_bytes(k_out).tobytes() == pt.compress_to_bytes(p_out).tobytes(),
          "base_mul kernel == plain at canonical encodings")
    k_enc = pt.compress_to_bytes(pt.ExtPoint(*(c[:8] for c in k_out)))
    for i, s in enumerate(ints_of(check_b, range(8))):
        check(bytes(k_enc[i]) == ex.ristretto_encode(ex.pt_base_mul(s)),
              f"base_mul row {i} == exact")
    check(max(err.values()) == 0, f"max_abs_err {err}")
    torch.cuda.synchronize()
    say(3, f"kernels == plain versions on the card at B={B_CHECK} (edge scalars "
           f"included), 8 rows each == exact; max_abs_err {err}")

    # -- phase 4: the main path at full width -----------------------------
    n = N_MAIN
    key_b, sk_b, r_b, uk_b, cs_b = (scalar_bytes(n) for _ in range(5))
    v_b, bl_b = small_bytes(n), small_bytes(n)
    vsum = v_b[:, :8].copy().view(np.uint64)[:, 0] + bl_b[:, :8].copy().view(np.uint64)[:, 0]
    vsum_b = np.zeros((n, 32), dtype=np.uint8)
    vsum_b[:, :8] = vsum.astype("<u8").reshape(n, 1).view(np.uint8)
    key_n, sk_n, r_n, uk_n, cs_n, v_n, bl_n, vsum_n = map(
        nib_of, (key_b, sk_b, r_b, uk_b, cs_b, v_b, bl_b, vsum_b))
    torch.cuda.synchronize()

    kp.reset_launches()
    t0 = time.perf_counter()
    gr = kp.base_mul(key_n)
    pk = qb.BatchPk(gr, kp.scalar_mul(sk_n, gr))
    before = dict(kp.LAUNCHES)
    comm = qb.generate_commitments(pk, r_n, v_n)
    ok0 = qb.verify_commitments(comm, sk_n, v_n)
    flagship = {k: kp.LAUNCHES[k] - before[k] for k in before}
    before = dict(kp.LAUNCHES)
    new_pk, new_comm = qb.update_accounts(pk, comm, bl_n, uk_n, cs_n)
    per_update = {k: kp.LAUNCHES[k] - before[k] for k in before}
    ok1 = qb.verify_commitments(new_comm, sk_n, vsum_n)
    ok2 = qb.verify_keypairs(new_pk, sk_n)
    j = int(rng.integers(0, n))
    bad_d = pt.ExtPoint(*(c.clone() for c in new_comm.d))
    for c, src in zip(bad_d, new_comm.d):
        c[j] = src[(j + 1) % n]
    ok3 = qb.verify_commitments(qb.BatchCommitment(new_comm.c, bad_d), sk_n, vsum_n)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    main_launches = dict(kp.LAUNCHES)
    check(flagship == {"scalar_mul": 3, "base_mul": 2}, f"flagship launches {flagship}")
    check(per_update == {"scalar_mul": 4, "base_mul": 1}, f"update launches {per_update}")
    check(main_launches == {"scalar_mul": 11, "base_mul": 6}, f"main launches {main_launches}")
    check(bool(ok0.all()), "flagship verify: every lane true")
    check(bool(ok1.all()), "verify_commitments after update: every lane true")
    check(bool(ok2.all()), "verify_keypairs after update: every lane true")
    check(torch.nonzero(~ok3).flatten().tolist() == [j], f"tampered lane {j} fails alone")
    lanes = sorted(rng.choice(n, size=32, replace=False).tolist())
    idx = torch.as_tensor(lanes, device=dev)

    def enc_rows(p):
        return [bytes(r) for r in pt.compress_to_bytes(pt.ExtPoint(*(c[idx] for c in p)))]

    got = [enc_rows(p) for p in (new_pk.gr, new_pk.grsk, new_comm.c, new_comm.d)]
    ks, sks, rs, uks, css = (ints_of(b, lanes) for b in (key_b, sk_b, r_b, uk_b, cs_b))
    vs, bls = ints_of(v_b, lanes), ints_of(bl_b, lanes)
    for i in range(len(lanes)):
        g = ex.pt_base_mul(ks[i])
        h = ex.pt_mul(sks[i], g)
        c = ex.pt_add(ex.pt_mul(css[i], g), ex.pt_mul(rs[i], g))
        d = ex.pt_add(ex.pt_add(ex.pt_base_mul(bls[i]), ex.pt_mul(css[i], h)),
                      ex.pt_add(ex.pt_base_mul(vs[i]), ex.pt_mul(rs[i], h)))
        want = [ex.pt_mul(uks[i], g), ex.pt_mul(uks[i], h), c, d]
        for k in range(4):
            check(got[k][i] == ex.ristretto_encode(want[k]), f"lane {lanes[i]} coord {k} == exact")
    say(4, f"N={n}: keys, flagship step (launches {flagship}), update_accounts "
           f"(launches {per_update}), verify_commitments + verify_keypairs all {n} lanes "
           f"true, tampered lane {j} alone false, 32 lanes == exact; main path launches "
           f"{main_launches} in {main_s:.3f} s (host clock)")

    # -- phase 5: the Account-object path ---------------------------------
    m = N_ACCOUNTS
    head = torch.arange(m, device=dev)
    wire = [pt.compress_to_bytes(pt.ExtPoint(*(c[head] for c in p)))
            for p in (new_pk.gr, new_pk.grsk, new_comm.c, new_comm.d)]
    accounts = [Account(RistrettoPublicKey(bytes(wire[0][i]), bytes(wire[1][i])),
                        ElGamalCommitment(bytes(wire[2][i]), bytes(wire[3][i])))
                for i in range(m)]
    prng = SeededRng(seed=b"chip-smoke-accounts")
    bl5 = [int(x) for x in rng.integers(0, 2**32, size=m)]
    uk5 = [prng.random_scalar() for _ in range(m)]
    cs5 = [prng.random_scalar() for _ in range(m)]
    kp.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    upd = update_accounts_device(accounts, bl5, uk5, cs5, device="cuda")
    upd_s = time.perf_counter() - t0
    base_pk = RistrettoPublicKey.generate_base_pk()
    values = [int(x) for x in rng.integers(0, 2**32, size=m)]
    delta, eps, rs5 = create_delta_and_epsilon_accounts_device(
        accounts, values, base_pk, SeededRng(seed=b"chip-smoke-delta"), device="cuda")
    acct_launches = dict(kp.LAUNCHES)
    check(acct_launches == {"scalar_mul": 8, "base_mul": 3}, f"account launches {acct_launches}")
    for i in range(16):
        host = Account.update_account(accounts[i], bl5[i], uk5[i], cs5[i])
        check(upd[i].as_bytes() == host.as_bytes(), f"update row {i} == host")
        hd = Account(accounts[i].pk, ElGamalCommitment.generate_commitment(
            accounts[i].pk, rs5[i], values[i]))
        he = Account(base_pk, ElGamalCommitment.generate_commitment(base_pk, rs5[i], values[i]))
        check(delta[i].as_bytes() == hd.as_bytes(), f"delta row {i} == host")
        check(eps[i].as_bytes() == he.as_bytes(), f"epsilon row {i} == host")
    check(sum(rs5) % ex.L == 0, "delta rscalars sum to 0")
    say(5, f"{m} Accounts from phase 4 wire bytes: update_accounts_device + delta/epsilon "
           f"(launches {acct_launches}), 16 rows byte-identical to host; update_accounts_device "
           f"{upd_s:.3f} s = {m / upd_s:.1f} accounts/s (host clock, host conversions included)")

    # -- phase 6: kernels against plain versions at the main path's widths,
    # then times on this card ---------------------------------------------
    plain, plain_ms = {}, {}
    plain["scalar_mul"], plain_ms["scalar_mul"] = time_once(lambda: pt.scalar_mul(sk_n, gr))
    plain["base_mul"], plain_ms["base_mul"] = time_once(lambda: pt.base_mul(key_n))
    main_out = {"scalar_mul": pk.grsk, "base_mul": gr}  # phase 4's own launches
    head_out = {"scalar_mul": kp.scalar_mul(sk_n[:m], pt.ExtPoint(*(c[:m] for c in gr))),
                "base_mul": kp.base_mul(key_n[:m])}
    for name in KERNELS:
        e_main = limb_err(main_out[name], plain[name])
        e_head = limb_err(head_out[name], pt.ExtPoint(*(c[:m] for c in plain[name])))
        check(e_main == 0, f"{name} phase-4 output == plain, limb for limb, N={n}")
        check(e_head == 0, f"{name} kernel == plain, limb for limb, first {m} lanes")
        err[name] = max(err[name], e_main, e_head)
    say(6, f"kernels == plain versions limb for limb on phase 4's inputs at N={n} "
           f"(phase 4's own outputs) and on their first {m} lanes; max_abs_err {err}")
    results = {}
    ms = {"scalar_mul": time_ms(lambda: kp.scalar_mul(sk_n, gr), reps=10, warmup=3),
          "base_mul": time_ms(lambda: kp.base_mul(key_n), reps=10, warmup=3)}
    upd_ms = time_ms(lambda: qb.update_accounts(pk, comm, bl_n, uk_n, cs_n), reps=3)
    lane_bytes = {"scalar_mul": (64 + 8 * fe.NLIMBS) * 4,
                  "base_mul": (64 + 4 * fe.NLIMBS) * 4}
    table_bytes = pt.niels_base_table(dev).numel() * 4
    for name in KERNELS:
        ops = n * sum(FIELD_OPS[name][k] * PRODUCTS[k] for k in PRODUCTS)
        nbytes = n * lane_bytes[name] + (table_bytes if name == "base_mul" else 0)
        t_ops, t_bytes = ops / int32_peak * 1e3, nbytes / MEM_BYTES_PER_S * 1e3
        results[name] = {
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": main_launches[name],
            "max_abs_err": err[name], "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        }
        say(6, f"{name} N={n}: kernel {ms[name]:.4f} ms, plain {plain_ms[name]:.2f} ms, "
               f"bound {results[name]['bound_ms']:.4f} ms ({results[name]['bound_by']}: "
               f"{ops:.4e} 32x32->64 limb products at {int32_peak:.4e}/s), no library "
               f"call [{card}]")
    say(6, f"update_accounts N={n} on device tensors: {upd_ms:.3f} ms = "
           f"{n / upd_ms * 1e3:.1f} account updates/s [{card}]")
    say(6, profile_line(lambda: qb.update_accounts(pk, comm, bl_n, uk_n, cs_n), card))

    # -- phase 7 ----------------------------------------------------------
    print(json.dumps({"kernels": [results[k] for k in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
