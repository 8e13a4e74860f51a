"""Time this checkout's kernels against another checkout's, in one
process on one GPU, and measure the card's rate of 32x32->64
multiply-adds.

    python3 -m quisquis_tpu_torch.kernel_ab --old-csrc OTHER/quisquis_tpu_torch/csrc \
        [--only msm_table keccak_f1600]

``--old-csrc`` is the ``csrc`` directory of the other checkout (for
example the parent commit unpacked with ``git archive``). The sources of
the kernels of ``ops/cuda_build.py`` that it holds (or of those ``--only``
names) are built with the same nvcc flags into ``build/kernel_ab/``;
their C entry points must have the signatures of ``ops/cuda_build.py``.
The script prints:

1. the card's name and power limit (nvidia-smi) and ptxas's registers,
   stack and spills of both builds;
2. that both builds give the same results at the main paths' shapes:
   msm_table at one row of 4,736 points and at R = 8 rows of 256 as
   projective points (X1 Z2 = X2 Z1, Y1 Z2 = Y2 Z1: a changed addition
   formula may change limbs, :data:`AS_POINTS`); scalar_mul and base_mul
   at N = 16,384 and msm_acc and msm_tail at both MSM shapes limb for
   limb; keccak_f1600 at 64 and 1,024 states byte for byte;
   ristretto_decode and ristretto_encode at the block's
   :data:`CODEC_POINTS` points (ok for ok and limb for limb, byte for
   byte), every other encoding made invalid;
3. each kernel's device time by replaying a CUDA graph that captured
   :data:`GRAPH_LAUNCHES` back-to-back launches, in turns: old, new, new,
   old; beside it the time of the same launches issued one by one from
   Python, by CUDA events (for kernels of tens of microseconds or less,
   the host work of a ctypes launch is about as long as the kernel and
   hides it there). Both builds are launched through their C entry points
   on preallocated outputs, so no time holds the torch wrappers' host work;
4. the SASS opcodes of the changed kernels (cuobjdump), with how many
   IMAD.WIDE instructions each holds and where its local-memory loads and
   stores (spills) sit among its barriers, and the measured rate of a kernel that
   does nothing but independent ``mad.wide.s32`` (32x32->64 multiply-add
   into 64 bits), in products per clock per SM at the card's maximum SM
   clock, and the graph-replay time of an empty kernel (the floor under
   every short kernel's time in 3).

It needs a CUDA GPU and nvcc, and exits non-zero without them.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .ops import cuda_build as cb
from .ops import cuda_point as kp
from .ops import device_keccak
from .ops import field as fe
from .ops import point as pt

N_SCALAR = 16_384
TAIL_POINTS = 4_736      # the range verifier's MSM at (64, 16, 64), padded
TAIL_ROWS, TAIL_K = 8, 256
SEED = 20261017

_VP, _CI = ctypes.c_void_p, ctypes.c_int
KECCAK_STATES = (64, 1_024)   # the range verifier's transcripts; a larger batch
#: kernels this checkout redesigned: their SASS summaries print
CHANGED = ("msm_table", "keccak_f1600")
#: kernels compared across builds as projective points, not limb for limb
AS_POINTS = ("msm_table",)
GRAPH_LAUNCHES = 20
CODEC_POINTS = 32 * 149   # a block's decode call: 32 lanes of the shuffle verifier

IMAD_SRC = r"""
#include <stdint.h>
// 16 independent 32x32->64 multiply-add chains a thread, as PTX so that
// nvcc keeps every one
extern "C" __global__ void imad_wide(const int32_t* in, int64_t* out, int iters) {
  int32_t a[16];
  int64_t acc[16];
  const int32_t b = in[threadIdx.x & 31] | 1;
  for (int k = 0; k < 16; ++k) { a[k] = in[(threadIdx.x + k) & 31]; acc[k] = k; }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      asm volatile("mad.wide.s32 %0, %1, %2, %0;" : "+l"(acc[k]) : "r"(a[k]), "r"(b));
  }
  int64_t s = 0;
  for (int k = 0; k < 16; ++k) s ^= acc[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_imad_wide(const void* in, void* out, int blocks, int threads, int iters,
                             void* stream) {
  imad_wide<<<blocks, threads, 0, (cudaStream_t)stream>>>((const int32_t*)in, (int64_t*)out,
                                                           iters);
  return (int)cudaGetLastError();
}
// a kernel that does nothing: the floor of a launch in a graph
extern "C" __global__ void empty_kernel() {}
extern "C" int run_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def nvcc_shared(sources, out_dir: Path, name: str) -> tuple[ctypes.CDLL, str]:
    """Compile sources with the port's flags into out_dir/name; (library,
    nvcc's output)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / name
    run = subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, "-shared", "-o", str(so),
                          *map(str, sources)],
                         capture_output=True, text=True, timeout=cb.NVCC_TIMEOUT_S)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed on {sources}:\n{run.stdout}{run.stderr}")
    return ctypes.CDLL(str(so)), run.stdout + run.stderr


def ptxas_lines(log: str, kernels) -> list[str]:
    """ptxas's 'Compiling entry' / 'Used' / 'spill' lines of the named kernels."""
    keep, out = False, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = any(k in line for k in kernels)
        if keep and ("Compiling entry" in line or "registers" in line or "spill" in line
                     or "stack frame" in line):
            out.append("  " + line.strip())
    return out


def median_ms(fn, reps: int):
    """Median, least and most host-clock ms of fn() over reps calls, each
    call synchronised with the GPU where one is present (the timer of
    ``chip_smoke.py``'s proving and transaction phases and of
    ``auto_rules``)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    walls = []
    for _ in range(reps):
        sync()
        t = time.perf_counter()
        fn()
        sync()
        walls.append((time.perf_counter() - t) * 1e3)
    return statistics.median(walls), min(walls), max(walls)


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, launches: int = GRAPH_LAUNCHES, replays: int = 5) -> float:
    """Device time of one fn() in ms: a CUDA graph captures `launches`
    back-to-back calls of fn (each a kernel launch on the current stream),
    then `replays` replays are timed by CUDA events, so no host work sits
    between the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def same_points(a: pt.ExtPoint, b: pt.ExtPoint) -> bool:
    """Every point of a equals b's as a projective point (limbs last)."""
    m = fe.mul
    return bool((fe.eq(m(a.x, b.z), m(b.x, a.z)) & fe.eq(m(a.y, b.z), m(b.y, a.z))).all())


def limbs_last(sums: pt.ExtPoint) -> pt.ExtPoint:
    """Limbs-before-points coordinates [..., NL, n] (window sums, tables)
    -> points [..., n, NL]."""
    return pt.ExtPoint(*(c.transpose(-1, -2).contiguous() for c in sums))


def same_limbs(a: pt.ExtPoint, b: pt.ExtPoint) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def sass_summary(so: Path, kernel: str) -> str:
    cuobjdump = Path(cb._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    body, keep = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            keep = kernel in line
        elif keep:
            body.append(line)
    ops, marks = collections.Counter(), []
    for line in body:
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m:
            op = m.group(2)
            if op.startswith(("STL", "LDL", "BAR")):  # where spills sit against the barriers
                marks.append(f"{op}@{sum(ops.values())}")
            ops[op] += 1
    total = sum(ops.values())
    top = ", ".join(f"{k} {v}" for k, v in ops.most_common(14))
    wide = sum(v for k, v in ops.items() if k.startswith("IMAD.WIDE"))
    return (f"SASS of {kernel}: {total} instructions, {wide} IMAD.WIDE*; "
            f"most frequent: {top}; local loads/stores and barriers at instruction: "
            f"{' '.join(marks) or 'none'}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", required=True, type=Path)
    ap.add_argument("--only", nargs="+", choices=tuple(cb.KERNELS),
                    help="compare and time these kernels only (default: every kernel whose "
                         "source the other checkout has)")
    args = ap.parse_args()
    names = args.only or tuple(k for k, (src, _, _) in cb.KERNELS.items()
                               if (args.old_csrc / src).is_file())
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA GPU is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    max_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    new_lib = cb.load_library()
    print("new build (this checkout):")
    print("\n".join(ptxas_lines(cb.build_log(), names)))
    out_dir = cb.build_root().parent / "kernel_ab"
    old = {}
    for name in names:
        src, entry, argtypes = cb.KERNELS[name]
        lib, log = nvcc_shared([args.old_csrc / src], out_dir, f"old_{name}.so")
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, _CI
        old[name] = fn
        print(f"old build ({args.old_csrc / src}):")
        print("\n".join(ptxas_lines(log, (name,))))

    # both builds run through their C entry points on preallocated outputs,
    # so no time below holds the torch wrappers' host work (which takes
    # longer than a 50 us kernel)
    libs = {"old": old, "new": {k: getattr(new_lib, cb.KERNELS[k][1]) for k in names}}

    def call(side, name, *cargs):
        rc = libs[side][name](*cargs, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{side} {name}: CUDA error {rc}")

    rng = np.random.default_rng(SEED)

    def nibbles(n):
        b = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
        b[:, 31] &= 0x0F
        return torch.as_tensor(pt.scalar_to_nibbles(b), device=dev)

    def ptrs(p):
        return [c.data_ptr() for c in p]

    def empty(shape):
        return pt.ExtPoint(*(torch.empty(shape, dtype=torch.int32, device=dev) for _ in range(4)))

    # scalar_mul and base_mul at N = 16,384
    nib = nibbles(N_SCALAR)
    base = kp.base_mul(nibbles(N_SCALAR))
    niels = pt.niels_base_table(dev)
    states = {f"{b} states": torch.as_tensor(rng.integers(0, 256, size=(b, 200), dtype=np.uint8),
                                             device=dev) for b in KECCAK_STATES}

    # the MSM stages: one row of 4,736 points (the range verifier's MSM,
    # padded) and R = 8 rows of 256
    def msm_inputs(rows, k):
        n = rows * k
        nib_rk = nibbles(n).reshape(rows, k, 64)
        pts = kp.base_mul(nibbles(n))
        digits, flat = kp.pad_rows(nib_rk, pt.ExtPoint(*(c.reshape(rows, k, fe.NLIMBS)
                                                         for c in pts)))
        return rows, digits, flat, kp.msm_table(flat)

    # the codec: encodings of random points, every other one made invalid
    codec_pts = kp.base_mul(nibbles(CODEC_POINTS))
    codec_enc = pt.compress_to_bytes_tensor(codec_pts)
    codec_enc[1::4] = torch.as_tensor(rng.integers(0, 256, size=(CODEC_POINTS // 4, 32),
                                                   dtype=np.uint8), device=dev)
    codec_enc[3::4, 31] |= 0x80

    one = f"N={N_SCALAR}"
    msm_in = {"1 row": msm_inputs(1, TAIL_POINTS), f"R={TAIL_ROWS}": msm_inputs(TAIL_ROWS, TAIL_K)}
    sums = {key: kp.msm_window_sums(d, t, rows) for key, (rows, d, _, t) in msm_in.items()}
    outs = {}

    def run(side, name, key):
        """One launch of a build's kernel; its output (kept per side)."""
        if name in ("scalar_mul", "base_mul"):
            o = outs.setdefault((side, name), empty((N_SCALAR, fe.NLIMBS)))
            first = ((nib.data_ptr(), *ptrs(base)) if name == "scalar_mul" else
                     (niels.data_ptr(), nib.data_ptr()))
            call(side, name, *first, *ptrs(o), N_SCALAR)
            return o
        if name == "ristretto_decode":
            ok = outs.setdefault((side, name, "ok"), torch.empty(CODEC_POINTS, dtype=torch.uint8,
                                                                  device=dev))
            o = outs.setdefault((side, name), empty((CODEC_POINTS, fe.NLIMBS)))
            call(side, name, codec_enc.data_ptr(), ok.data_ptr(), *ptrs(o), CODEC_POINTS)
            return ok, o
        if name == "ristretto_encode":
            o = outs.setdefault((side, name), torch.empty((CODEC_POINTS, 32), dtype=torch.uint8,
                                                          device=dev))
            call(side, name, *ptrs(codec_pts), o.data_ptr(), CODEC_POINTS)
            return o
        if name == "keccak_f1600":
            st = states[key]
            o = outs.setdefault((side, name, key), torch.empty_like(st))
            call(side, name, st.data_ptr(), o.data_ptr(), st.shape[0])
            return o
        rows, digits, flat, table = msm_in[key]
        if name == "msm_table":
            o = outs.setdefault((side, name, key), empty((16, fe.NLIMBS, flat.x.shape[0])))
            call(side, name, *ptrs(flat), *ptrs(o), flat.x.shape[0])
        elif name == "msm_acc":
            o = outs.setdefault((side, name, key), empty((rows, 64, fe.NLIMBS, 128)))
            call(side, name, digits.data_ptr(), *ptrs(table), *ptrs(o), rows,
                 digits.shape[1] // (rows * 128), 128)
        else:  # msm_tail, with the scratch its wrapper makes
            o = outs.setdefault((side, name, key), empty((rows, fe.NLIMBS)))
            totals = torch.empty((rows, 64, 4, fe.NLIMBS), dtype=torch.int32, device=dev)
            done = torch.zeros((rows,), dtype=torch.int32, device=dev)
            call(side, name, *ptrs(sums[key]), totals.data_ptr(), done.data_ptr(), *ptrs(o),
                 rows, 128)
        return o

    cases = [("scalar_mul", one, one, 10), ("base_mul", one, one, 20)]
    for name in ("msm_table", "msm_acc", "msm_tail"):
        cases += [(name, "1 row", f"1 row of {TAIL_POINTS} points", 20),
                  (name, f"R={TAIL_ROWS}", f"{TAIL_ROWS} rows of {TAIL_K} points", 20)]
    cases += [("keccak_f1600", key, key, 50) for key in states]
    codec = f"{CODEC_POINTS} points"
    cases += [(name, codec, codec, 50) for name in ("ristretto_decode", "ristretto_encode")]
    cases = [c for c in cases if c[0] in names]
    same = {}
    for name, key, _, _ in cases:
        a, b = run("old", name, key), run("new", name, key)
        if name == "keccak_f1600":
            same[f"{name} {key}"] = torch.equal(a, b) and torch.equal(
                b, device_keccak.f1600_plain(states[key]))
            continue
        if name == "ristretto_decode":
            p_ok, p_pts = pt.decompress_bytes_tensor(codec_enc)
            same[f"{name} {key}"] = (torch.equal(a[0], b[0]) and same_limbs(a[1], b[1])
                                     and torch.equal(b[0].bool(), p_ok) and same_limbs(b[1], p_pts))
            continue
        if name == "ristretto_encode":
            same[f"{name} {key}"] = torch.equal(a, b) and torch.equal(
                b, pt.compress_to_bytes_tensor(codec_pts))
            continue
        if name in ("msm_table", "msm_acc"):
            a, b = limbs_last(a), limbs_last(b)
        same[f"{name} {key}"] = same_points(a, b) if name in AS_POINTS else same_limbs(a, b)
    print(f"old == new ({', '.join(AS_POINTS)} as projective points, keccak_f1600 and "
          f"ristretto_encode byte for byte and == the plain version, ristretto_decode also; the "
          f"others limb for limb): {same}", flush=True)
    if not all(same.values()):
        print("kernel_ab: the two builds disagree", file=sys.stderr)
        return 1

    order = ("old", "new", "new", "old")
    for name, key, shape, reps in cases:
        g = [graph_ms(lambda side=side: run(side, name, key)) for side in order]
        t = [time_ms(lambda side=side: run(side, name, key), reps) for side in order]
        print(f"{name} {shape}: device time by graph replay ({GRAPH_LAUNCHES} launches a "
              f"graph, in turns old, new, new, old): {g[0]:.4f}, {g[1]:.4f}, {g[2]:.4f}, "
              f"{g[3]:.4f} ms, old/new = {(g[0] + g[3]) / (g[1] + g[2]):.2f}; launched one by "
              f"one, CUDA events over {reps}: {t[0]:.4f}, {t[1]:.4f}, {t[2]:.4f}, {t[3]:.4f} ms, "
              f"old/new = {(t[0] + t[3]) / (t[1] + t[2]):.2f} [{card}]", flush=True)

    for kernel in (k for k in CHANGED if k in names):
        print(sass_summary(Path(new_lib._name), f"{kernel}_kernel"), flush=True)
        print("  old: " + sass_summary(out_dir / f"old_{kernel}.so", f"{kernel}_kernel"),
              flush=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        src = Path(tmp) / "imad_wide.cu"
        src.write_text(IMAD_SRC)
        lib, _ = nvcc_shared([src], Path(tmp), "imad.so")
        print(sass_summary(Path(tmp) / "imad.so", "imad_wide"), flush=True)
        fn = lib.run_imad_wide
        fn.argtypes, fn.restype = [_VP, _VP, _CI, _CI, _CI, _VP], _CI
        blocks, threads, iters = sms * 8, 256, 4096
        src_t = torch.arange(1, 33, dtype=torch.int32, device=dev)
        out_t = torch.empty(blocks * threads, dtype=torch.int64, device=dev)

        def run_imad():
            rc = fn(src_t.data_ptr(), out_t.data_ptr(), blocks, threads, iters,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"imad_wide: CUDA error {rc}")

        empty = lib.run_empty
        empty.argtypes, empty.restype = [_VP], _CI
        floor = graph_ms(lambda: empty(torch.cuda.current_stream().cuda_stream))
        print(f"launch floor: an empty kernel (one block of 32 threads) takes {floor:.4f} ms a "
              f"launch by graph replay [{card}]", flush=True)
        ms = time_ms(run_imad, 5)
        products = blocks * threads * iters * 16
        per_clk = products / (ms * 1e-3) / sms / (max_mhz * 1e6)
        print(f"mad.wide.s32 rate: {products:.4e} products in {ms:.4f} ms = "
              f"{products / ms * 1e3:.4e}/s = {per_clk:.1f} a clock per SM at the maximum "
              f"SM clock {max_mhz} MHz ({sms} SMs) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
