"""Build and load the port's CUDA kernels; count their launches.

At first use nvcc compiles each ``.cu`` file of :data:`KERNEL_SOURCES` (all
at once, one process each) for ``sm_90a`` and links them into one shared
library with a plain C interface, loaded with ctypes. The library lives
under ``build/quisquis_tpu_torch/<hash of the sources and flags>/`` beside
the package, and a file lock (:func:`.host_build.build_lock`) lets
concurrent processes share one build.

The wrappers (:mod:`.cuda_point`, :mod:`.cuda_keccak`) call
:func:`launch`, which runs one C entry point on the current stream, raises
on a CUDA error and adds one to :data:`LAUNCHES`. Nothing here catches a
failed build or launch and carries on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .host_build import CSRC, build_lock, build_root
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 900

_VP, _CI = ctypes.c_void_p, ctypes.c_int
#: kernel name -> (source file, C entry point, its argument types)
KERNELS = {
    "scalar_mul": ("scalar_mul.cu", "qq_scalar_mul", [_VP] * 9 + [_CI, _VP]),
    "base_mul": ("base_mul.cu", "qq_base_mul", [_VP] * 6 + [_CI, _VP]),
    "msm_table": ("msm_table.cu", "qq_msm_table", [_VP] * 8 + [_CI, _VP]),
    "msm_acc": ("msm_acc.cu", "qq_msm_acc", [_VP] * 9 + [_CI, _CI, _CI, _VP]),
    "msm_tail": ("msm_tail.cu", "qq_msm_tail", [_VP] * 10 + [_CI, _CI, _VP]),
    "keccak_f1600": ("keccak_f1600.cu", "qq_keccak_f1600", [_VP, _VP, _CI, _VP]),
}
KERNEL_SOURCES = tuple(src for src, _, _ in KERNELS.values())

#: kernel launches per wrapper; callers may reset them to 0
LAUNCHES = {name: 0 for name in KERNELS}

_LIB = None
_BUILD = {"log": "", "seconds": 0.0}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the port's CUDA kernels are built from source at first use")


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode() + path.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out_dir: Path, so: Path) -> str:
    objs, procs = [], []
    for src in KERNEL_SOURCES:
        obj = out_dir / (Path(src).stem + f".{os.getpid()}.o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    try:
        for src, proc in procs:
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            log.append(f"== nvcc {src}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{out}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = so.with_name(so.name + f".{os.getpid()}")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=NVCC_TIMEOUT_S)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n{link.stdout}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, so)
    return "\n".join(log)


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    nvcc = _nvcc()
    t0 = time.perf_counter()
    out_dir = build_root() / _source_key()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libqq_cuda.so"
    log_path = out_dir / "build.log"
    with build_lock():
        if not so.exists():
            log_path.write_text(_compile(nvcc, out_dir, so))
    lib = ctypes.CDLL(str(so))
    for _, entry, argtypes in KERNELS.values():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = _CI
    _BUILD["log"] = log_path.read_text() if log_path.exists() else ""
    _BUILD["seconds"] = time.perf_counter() - t0
    _LIB = lib
    return lib


def build_log() -> str:
    """nvcc's output (ptxas registers and spills) for the loaded library."""
    return _BUILD["log"]


def build_seconds() -> float:
    return _BUILD["seconds"]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch(kernel: str, dev: torch.device, *args) -> None:
    """Run one kernel's C entry point on ``dev``'s current stream (the
    stream is appended to ``args``), raise on a CUDA error, count it."""
    fn = getattr(load_library(), KERNELS[kernel][1])
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    LAUNCHES[kernel] += 1


def check_tensor(t: torch.Tensor, name: str, shape, device: torch.device,
                 dtype: torch.dtype = torch.int32) -> None:
    """Raise unless t is a contiguous tensor of this dtype, device and
    shape (None in ``shape`` matches any size)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        want = [("*" if s is None else s) for s in shape]
        raise ValueError(f"{name}: expected shape {want}, got {list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
