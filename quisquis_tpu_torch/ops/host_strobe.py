"""The C++ STROBE-128 of ``csrc/host_strobe.cpp``, for the host transcripts.

:class:`NativeStrobe128` has the interface of the pure-Python
:class:`~quisquis_tpu_torch.ops.strobe.Strobe128` and gives the same bytes
(``tests/test_torch_host_strobe.py``); the pure-Python class stays as its
plain version. It keeps the whole sponge in one 208-byte context:
``[0, 200)`` the Keccak state, then ``pos``, ``pos_begin`` and ``cur_flags``
(``csrc/host_strobe.cpp``, ``StrobeCtx``).

g++ builds the library at first use into
``build/quisquis_tpu_torch/host_strobe/<hash of the source and flags>/``,
under the lock of the kernels' builds (:func:`.cuda_build.build_lock`), and
ctypes loads it. Where g++ is missing, or the build or the load fails,
:func:`available` is False (:func:`build_error` says why) and
``accounts/transcript.py`` keeps the pure-Python class.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import time
from typing import Optional

from .cuda_build import CSRC, build_lock, build_root

SOURCE = CSRC / "host_strobe.cpp"
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
CXX_TIMEOUT_S = 300
CTX_BYTES = 208

_CP, _U64, _CI = ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int
_ARGTYPES = {
    "strobe_init": [_CP, _CP, _U64],
    "strobe_meta_ad": [_CP, _CP, _U64, _CI],
    "strobe_ad": [_CP, _CP, _U64, _CI],
    "strobe_prf": [_CP, _CP, _U64, _CI],
    "strobe_key": [_CP, _CP, _U64, _CI],
    "strobe_append_messages": [_CP, _CP, _U64],
    "strobe_rekey_witnesses": [_CP, _CP, _U64, _CP, _U64, _U64],
}

_LIB: Optional[ctypes.CDLL] = None
_STATE = {"tried": False, "seconds": 0.0, "compiled": False, "error": ""}


def _build(cxx: str) -> str:
    """Compile once per source hash; returns the library's path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    out_dir = build_root() / "host_strobe" / h.hexdigest()[:16]
    so = out_dir / "libqq_host_strobe.so"
    with build_lock():
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(so.name + f".{os.getpid()}")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=CXX_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE.name} (exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
            _STATE["compiled"] = True
    return str(so)


def load_library() -> Optional[ctypes.CDLL]:
    """Build (once per source hash) and load the library; None where that
    is not possible here (see :func:`build_error`)."""
    global _LIB
    if _STATE["tried"]:
        return _LIB
    _STATE["tried"] = True
    cxx = shutil.which("g++")
    if cxx is None:
        _STATE["error"] = "g++ not found on PATH"
        return None
    t0 = time.perf_counter()
    try:
        lib = ctypes.CDLL(_build(cxx))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _STATE["error"] = str(e)
        return None
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None   # every entry point returns void
    _STATE["seconds"] = time.perf_counter() - t0
    _LIB = lib
    return lib


def available() -> bool:
    return load_library() is not None


def build_seconds() -> float:
    """Seconds :func:`load_library` took (g++ included when it compiled)."""
    return _STATE["seconds"]


def compiled() -> bool:
    """Whether this process compiled the library (else it loaded a build
    of the same source from ``build/``)."""
    return _STATE["compiled"]


def build_error() -> str:
    return _STATE["error"]


class NativeStrobe128:
    """STROBE-128 context backed by the C++ library: the pure-Python
    Strobe128's operations, and two batched ones of the transcript layer
    (:meth:`append_messages`, :meth:`rekey_witnesses`)."""

    __slots__ = ("ctx",)

    def __init__(self, protocol_label: bytes, _raw: bool = False):
        self.ctx = bytearray(CTX_BYTES)
        if not _raw:
            load_library().strobe_init(self._buf(), bytes(protocol_label), len(protocol_label))

    def clone(self) -> "NativeStrobe128":
        c = NativeStrobe128(b"", _raw=True)
        c.ctx = bytearray(self.ctx)
        return c

    def _buf(self):
        return (ctypes.c_char * CTX_BYTES).from_buffer(self.ctx)

    def meta_ad(self, data: bytes, more: bool) -> None:
        _LIB.strobe_meta_ad(self._buf(), bytes(data), len(data), int(more))

    def ad(self, data: bytes, more: bool) -> None:
        _LIB.strobe_ad(self._buf(), bytes(data), len(data), int(more))

    def prf(self, n: int, more: bool) -> bytes:
        out = ctypes.create_string_buffer(n)
        _LIB.strobe_prf(self._buf(), out, n, int(more))
        return out.raw[:n]

    def key(self, data: bytes, more: bool) -> None:
        _LIB.strobe_key(self._buf(), bytes(data), len(data), int(more))

    def append_messages(self, items) -> None:
        """merlin append_message over (label, message) pairs, in one call."""
        buf = b"".join(struct.pack("<I", len(label)) + label + struct.pack("<I", len(msg)) + msg
                       for label, msg in items)
        _LIB.strobe_append_messages(self._buf(), buf, len(items))

    def rekey_witnesses(self, label: bytes, witnesses: bytes, wlen: int, count: int) -> None:
        """merlin rekey_with_witness_bytes over ``count`` witnesses of
        ``wlen`` bytes packed in ``witnesses``, in one call."""
        if len(witnesses) < wlen * count:
            raise ValueError("rekey_witnesses: buffer shorter than count * wlen")
        _LIB.strobe_rekey_witnesses(self._buf(), bytes(label), len(label), bytes(witnesses),
                                    wlen, count)
