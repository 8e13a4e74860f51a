"""Build and load the port's C++ host libraries (g++, no CUDA, no torch).

:class:`HostLibrary` builds one standalone ``csrc/*.cpp`` file at first use
into ``build/quisquis_tpu_torch/<stem>/<hash>/`` beside the package, under
:func:`build_lock`, the file lock that the CUDA kernels' build
(:mod:`.cuda_build`) shares. Nothing here imports torch, so a process that
only needs the host curve or STROBE (a daemon client, a worker) loads no
CUDA module.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"


def build_root() -> Path:
    return _PKG.parent / "build" / "quisquis_tpu_torch"


@contextlib.contextmanager
def build_lock():
    """The file lock under which a process builds a library of the port
    (the CUDA kernels of :mod:`.cuda_build`, the host libraries of
    :class:`HostLibrary`)."""
    build_root().mkdir(parents=True, exist_ok=True)
    with open(build_root() / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


class HostLibrary:
    """A standalone C++ host library of ``csrc/`` (plain ``extern "C"``, no
    include beyond the standard library): g++ builds it at first use, once
    per hash of its source and flags, into
    ``build/quisquis_tpu_torch/<stem>/<hash>/`` under :func:`build_lock`,
    and ctypes loads it with the given signatures (name -> (argument
    types, return type)). Where g++ is missing, or the build or the load
    fails, :meth:`load` returns None and :meth:`build_error` says why."""

    def __init__(self, source: Path, flags, signatures: dict, timeout_s: int = 300):
        self.source, self.flags, self.signatures = source, tuple(flags), signatures
        self.timeout_s = timeout_s
        self.lib = None
        self._tried, self._seconds, self._compiled, self._error = False, 0.0, False, ""

    def _build(self, cxx: str) -> str:
        h = hashlib.sha256(" ".join(self.flags).encode() + self.source.read_bytes())
        out_dir = build_root() / self.source.stem / h.hexdigest()[:16]
        so = out_dir / f"libqq_{self.source.stem}.so"
        with build_lock():
            if not so.exists():
                out_dir.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(so.name + f".{os.getpid()}")
                proc = subprocess.run([cxx, *self.flags, "-o", str(tmp), str(self.source)],
                                      capture_output=True, text=True, timeout=self.timeout_s)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed on {self.source.name} (exit "
                                       f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, so)
                self._compiled = True
        return str(so)

    def load(self):
        """The loaded library, built first where needed; None where that is
        not possible here."""
        if self._tried:
            return self.lib
        self._tried = True
        cxx = shutil.which("g++")
        if cxx is None:
            self._error = "g++ not found on PATH"
            return None
        t0 = time.perf_counter()
        try:
            lib = ctypes.CDLL(self._build(cxx))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            self._error = str(e)
            return None
        for name, (argtypes, restype) in self.signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        self._seconds = time.perf_counter() - t0
        self.lib = lib
        return lib

    def available(self) -> bool:
        return self.load() is not None

    def build_seconds(self) -> float:
        """Seconds :meth:`load` took (g++ included when it compiled)."""
        return self._seconds

    def compiled(self) -> bool:
        """Whether this process compiled the library (else it loaded a build
        of the same source from ``build/``)."""
        return self._compiled

    def build_error(self) -> str:
        return self._error
