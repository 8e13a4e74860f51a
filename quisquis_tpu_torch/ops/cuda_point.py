"""Wrappers of the port's two CUDA kernels; the counterpart of the JAX
package's ``ops/pallas_point.py``.

* :func:`scalar_mul` launches ``csrc/scalar_mul.cu`` (variable-base s*P),
* :func:`base_mul` launches ``csrc/base_mul.cu`` (fixed-base s*B).

For tensors on the CPU each calls its plain version in
:mod:`quisquis_tpu_torch.ops.point`; for CUDA tensors it launches the kernel
or raises. Each launch adds one to :data:`LAUNCHES`.

Build: at first use, nvcc compiles each ``.cu`` file (all at once, one
process each) for ``sm_90a`` and links them into one shared library with a
plain C interface, loaded with ctypes. The library lives under
``build/quisquis_tpu_torch/<hash of the sources and flags>/`` beside the
package, and a file lock lets concurrent processes share one build.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from . import field as fe
from . import point as pt

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
KERNEL_SOURCES = ("scalar_mul.cu", "base_mul.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 900

#: kernel launches per wrapper; callers may reset them to 0
LAUNCHES = {"scalar_mul": 0, "base_mul": 0}

_LIB = None
_BUILD = {"log": "", "seconds": 0.0}


def build_root() -> Path:
    return _PKG.parent / "build" / "quisquis_tpu_torch"


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
    with open(build_root() / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            log_path.write_text(_compile(nvcc, out_dir, so))
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.qq_scalar_mul.argtypes = [vp] * 9 + [ci, vp]
    lib.qq_scalar_mul.restype = ci
    lib.qq_base_mul.argtypes = [vp] * 6 + [ci, vp]
    lib.qq_base_mul.restype = ci
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


def _check(t: torch.Tensor, name: str, cols: int, device: torch.device) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dim() != 2 or t.shape[1] != cols:
        raise ValueError(f"{name}: expected shape [B, {cols}], got {list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _empty_point(n: int, device: torch.device) -> pt.ExtPoint:
    return pt.ExtPoint(*(torch.empty((n, fe.NLIMBS), dtype=torch.int32, device=device)
                         for _ in range(4)))


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


def scalar_mul(nibbles: torch.Tensor, p: pt.ExtPoint) -> pt.ExtPoint:
    """s*P per lane: nibbles int32 [B, 64], P coords int32 [B, 10]."""
    dev = nibbles.device
    if dev.type == "cpu":
        return pt.scalar_mul(nibbles, p)
    if dev.type != "cuda":
        raise ValueError(f"scalar_mul: unsupported device {dev}")
    n = nibbles.shape[0]
    _check(nibbles, "nibbles", pt.NWINDOWS, dev)
    for name, c in zip("xyzt", p):
        _check(c, f"p.{name}", fe.NLIMBS, dev)
        if c.shape[0] != n:
            raise ValueError(f"p.{name}: batch {c.shape[0]} != nibbles batch {n}")
    out = _empty_point(n, dev)
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.qq_scalar_mul(nibbles.data_ptr(), *(c.data_ptr() for c in p),
                               *(c.data_ptr() for c in out), n, stream)
    _raise_on(rc, "scalar_mul")
    LAUNCHES["scalar_mul"] += 1
    return out


def base_mul(nibbles: torch.Tensor) -> pt.ExtPoint:
    """s*B per lane: nibbles int32 [B, 64]."""
    dev = nibbles.device
    if dev.type == "cpu":
        return pt.base_mul(nibbles)
    if dev.type != "cuda":
        raise ValueError(f"base_mul: unsupported device {dev}")
    _check(nibbles, "nibbles", pt.NWINDOWS, dev)
    n = nibbles.shape[0]
    out = _empty_point(n, dev)
    if n == 0:
        return out
    table = pt.niels_base_table(dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.qq_base_mul(table.data_ptr(), nibbles.data_ptr(),
                             *(c.data_ptr() for c in out), n, stream)
    _raise_on(rc, "base_mul")
    LAUNCHES["base_mul"] += 1
    return out
