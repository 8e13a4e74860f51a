"""Time this checkout's point kernels against another checkout's, in one
process on one GPU, and measure the card's rate of 32x32->64
multiply-adds.

    python3 -m quisquis_tpu_torch.kernel_ab --old-csrc OTHER/quisquis_tpu_torch/csrc

``--old-csrc`` is the ``csrc`` directory of the other checkout (for
example the parent commit unpacked with ``git archive``). Its
``scalar_mul.cu``, ``msm_tail.cu``, ``base_mul.cu``, ``msm_table.cu`` and
``msm_acc.cu`` are built with the same nvcc flags into
``build/kernel_ab/``; their C entry points must have the signatures of
slice 2 (``qq_msm_tail``: 8 pointers, rows and lanes; the others as in
``ops/cuda_build.py``). The script prints:

1. the card's name and power limit (nvidia-smi) and ptxas's registers,
   stack and spills of both builds;
2. that both builds give the same points at the main paths' shapes:
   scalar_mul at N = 16,384 and msm_tail at one row of 128 lanes (window
   sums of 4,736 points) and at R = 8 at canonical encodings (their
   schedules changed); base_mul at N = 16,384, msm_table and msm_acc on
   4,736 points limb for limb (same schedules, shared field library);
3. each kernel's time by CUDA events, in turns: old, new, new, old;
4. the SASS opcodes of the two new kernels (cuobjdump), with how many
   IMAD.WIDE instructions each holds, and the measured rate of a kernel that
   does nothing but independent ``mad.wide.s32`` (32x32->64 multiply-add
   into 64 bits), in products per clock per SM at the card's maximum SM
   clock.

It needs a CUDA GPU and nvcc, and exits non-zero without them.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .ops import cuda_build as cb
from .ops import cuda_point as kp
from .ops import field as fe
from .ops import point as pt

N_SCALAR = 16_384
TAIL_POINTS = 4_736      # the range verifier's MSM at (64, 16, 64), padded
TAIL_ROWS, TAIL_K = 8, 256
SEED = 20261017

_VP, _CI = ctypes.c_void_p, ctypes.c_int
SAME_SCHEDULE = ("base_mul", "msm_table", "msm_acc")
_OLD_ENTRIES = {"scalar_mul": cb.KERNELS["scalar_mul"],
                "msm_tail": ("msm_tail.cu", "qq_msm_tail", [_VP] * 8 + [_CI, _CI, _VP]),
                **{k: cb.KERNELS[k] for k in SAME_SCHEDULE}}

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


def encodings(p: pt.ExtPoint) -> bytes:
    return pt.compress_to_bytes(p).tobytes()


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
    ops = collections.Counter()
    for line in body:
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m:
            ops[m.group(2)] += 1
    total = sum(ops.values())
    top = ", ".join(f"{k} {v}" for k, v in ops.most_common(14))
    wide = sum(v for k, v in ops.items() if k.startswith("IMAD.WIDE"))
    return (f"SASS of {kernel}: {total} instructions, {wide} IMAD.WIDE*; "
            f"most frequent: {top}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", required=True, type=Path)
    args = ap.parse_args()
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
    print("\n".join(ptxas_lines(cb.build_log(), tuple(_OLD_ENTRIES))))
    out_dir = cb.build_root().parent / "kernel_ab"
    old = {}
    for name, (src, entry, argtypes) in _OLD_ENTRIES.items():
        lib, log = nvcc_shared([args.old_csrc / src], out_dir, f"old_{name}.so")
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, _CI
        old[name] = fn
        print(f"old build ({args.old_csrc / src}):")
        print("\n".join(ptxas_lines(log, (name,))))

    def old_launch(name, *ptrs):
        rc = old[name](*ptrs, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"old {name}: CUDA error {rc}")

    rng = np.random.default_rng(SEED)

    def nibbles(n):
        b = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
        b[:, 31] &= 0x0F
        return torch.as_tensor(pt.scalar_to_nibbles(b), device=dev)

    def ptrs(p):
        return [c.data_ptr() for c in p]

    def empty(shape):
        return pt.ExtPoint(*(torch.empty(shape, dtype=torch.int32, device=dev) for _ in range(4)))

    # scalar_mul at N = 16,384
    nib = nibbles(N_SCALAR)
    base = kp.base_mul(nibbles(N_SCALAR))
    out_old = empty((N_SCALAR, fe.NLIMBS))

    def run_old_sm():
        old_launch("scalar_mul", nib.data_ptr(), *ptrs(base), *ptrs(out_old), N_SCALAR)
        return out_old

    def run_new_sm():
        return kp.scalar_mul(nib, base)

    same_sm = encodings(run_old_sm()) == encodings(run_new_sm())

    # msm_tail: window sums of one row of 4,736 points and of 8 rows of 256
    def sums_of(rows, k):
        n = rows * k
        nib_rk = nibbles(n).reshape(rows, k, 64)
        pts = kp.base_mul(nibbles(n))
        digits, flat = kp.pad_rows(nib_rk, pt.ExtPoint(*(c.reshape(rows, k, fe.NLIMBS)
                                                         for c in pts)))
        return kp.msm_window_sums(digits, kp.msm_table(flat), rows)

    tails = {"1 row": sums_of(1, TAIL_POINTS), f"R={TAIL_ROWS}": sums_of(TAIL_ROWS, TAIL_K)}
    tail_old_out = {k: empty((s.x.shape[0], fe.NLIMBS)) for k, s in tails.items()}

    def run_old_tail(key):
        s = tails[key]
        old_launch("msm_tail", *ptrs(s), *ptrs(tail_old_out[key]), s.x.shape[0], 128)
        return tail_old_out[key]

    same_tail = {k: encodings(run_old_tail(k)) == encodings(kp.msm_tail(s))
                 for k, s in tails.items()}

    # the kernels whose schedules did not change: base_mul at N = 16,384,
    # msm_table and msm_acc on the verifier's 4,736 points
    niels = pt.niels_base_table(dev)
    digits, flat = kp.pad_rows(nibbles(TAIL_POINTS)[None],
                               pt.ExtPoint(*(c[None] for c in kp.base_mul(nibbles(TAIL_POINTS)))))
    table = kp.msm_table(flat)
    outs = {"base_mul": empty((N_SCALAR, fe.NLIMBS)),
            "msm_table": empty((16, fe.NLIMBS, TAIL_POINTS)),
            "msm_acc": empty((1, 64, fe.NLIMBS, 128))}
    old_args = {"base_mul": (niels.data_ptr(), nib.data_ptr(), *ptrs(outs["base_mul"]), N_SCALAR),
                "msm_table": (*ptrs(flat), *ptrs(outs["msm_table"]), TAIL_POINTS),
                "msm_acc": (digits.data_ptr(), *ptrs(table), *ptrs(outs["msm_acc"]), 1,
                            TAIL_POINTS // 128, 128)}
    new_runs = {"base_mul": lambda: kp.base_mul(nib), "msm_table": lambda: kp.msm_table(flat),
                "msm_acc": lambda: kp.msm_window_sums(digits, table, 1)}

    def run_old_same(name):
        old_launch(name, *old_args[name])
        return outs[name]

    same_limbs = {k: all(torch.equal(a, b) for a, b in zip(run_old_same(k), new_runs[k]()))
                  for k in SAME_SCHEDULE}
    print(f"same points at canonical encodings: scalar_mul N={N_SCALAR} {same_sm}; "
          f"msm_tail {same_tail}; limb for limb: {same_limbs}", flush=True)
    if not (same_sm and all(same_tail.values()) and all(same_limbs.values())):
        print("kernel_ab: the two builds disagree", file=sys.stderr)
        return 1

    cases = [("scalar_mul", f"N={N_SCALAR}", run_old_sm, run_new_sm, 10)]
    for key, s in tails.items():
        cases.append(("msm_tail", key, lambda key=key: run_old_tail(key),
                      lambda s=s: kp.msm_tail(s), 20))
    shapes = {"base_mul": f"N={N_SCALAR}", "msm_table": f"{TAIL_POINTS} points",
              "msm_acc": f"1 row of {TAIL_POINTS} points"}
    for k in SAME_SCHEDULE:
        cases.append((k, shapes[k], lambda k=k: run_old_same(k), new_runs[k], 20))
    for name, shape, run_old, run_new, reps in cases:
        t = [time_ms(f, reps) for f in (run_old, run_new, run_new, run_old)]
        print(f"{name} {shape}: old {t[0]:.4f} ms, new {t[1]:.4f} ms, new {t[2]:.4f} ms, "
              f"old {t[3]:.4f} ms (CUDA events, {reps} launches each, in that order); "
              f"old/new = {(t[0] + t[3]) / (t[1] + t[2]):.2f} [{card}]", flush=True)

    for kernel in ("scalar_mul_kernel", "msm_tail_kernel"):
        print(sass_summary(Path(new_lib._name), kernel), flush=True)
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

        def run():
            rc = fn(src_t.data_ptr(), out_t.data_ptr(), blocks, threads, iters,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"imad_wide: CUDA error {rc}")

        ms = time_ms(run, 5)
        products = blocks * threads * iters * 16
        per_clk = products / (ms * 1e-3) / sms / (max_mhz * 1e6)
        print(f"mad.wide.s32 rate: {products:.4e} products in {ms:.4f} ms = "
              f"{products / ms * 1e3:.4e}/s = {per_clk:.1f} a clock per SM at the maximum "
              f"SM clock {max_mhz} MHz ({sms} SMs) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
