"""The C++ STROBE-128 of ``csrc/host_strobe.cpp``, for the host transcripts.

:class:`NativeStrobe128` has the interface of the pure-Python
:class:`~quisquis_tpu_torch.ops.strobe.Strobe128` and gives the same bytes
(``tests/test_torch_host_strobe.py``); the pure-Python class stays as its
plain version. It keeps the whole sponge in one 208-byte context:
``[0, 200)`` the Keccak state, then ``pos``, ``pos_begin`` and ``cur_flags``
(``csrc/host_strobe.cpp``, ``StrobeCtx``).

g++ builds the library at first use into
``build/quisquis_tpu_torch/host_strobe/<hash of the source and flags>/``,
through :class:`.host_build.HostLibrary`, and ctypes loads it. Where
g++ is missing, or the build or the load fails, :func:`available` is False (:func:`build_error` says why) and
``accounts/transcript.py`` keeps the pure-Python class.
"""

from __future__ import annotations

import ctypes
import struct

from .host_build import CSRC, HostLibrary

SOURCE = CSRC / "host_strobe.cpp"
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
CTX_BYTES = 208

_CP, _U64, _CI = ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int
_SIGNATURES = {   # every entry point returns void
    "strobe_init": ([_CP, _CP, _U64], None),
    "strobe_meta_ad": ([_CP, _CP, _U64, _CI], None),
    "strobe_ad": ([_CP, _CP, _U64, _CI], None),
    "strobe_prf": ([_CP, _CP, _U64, _CI], None),
    "strobe_key": ([_CP, _CP, _U64, _CI], None),
    "strobe_append_messages": ([_CP, _CP, _U64], None),
    "strobe_rekey_witnesses": ([_CP, _CP, _U64, _CP, _U64, _U64], None),
}

_HOST = HostLibrary(SOURCE, CXX_FLAGS, _SIGNATURES)
load_library = _HOST.load
available = _HOST.available
build_seconds = _HOST.build_seconds
compiled = _HOST.compiled
build_error = _HOST.build_error


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
        _HOST.lib.strobe_meta_ad(self._buf(), bytes(data), len(data), int(more))

    def ad(self, data: bytes, more: bool) -> None:
        _HOST.lib.strobe_ad(self._buf(), bytes(data), len(data), int(more))

    def prf(self, n: int, more: bool) -> bytes:
        out = ctypes.create_string_buffer(n)
        _HOST.lib.strobe_prf(self._buf(), out, n, int(more))
        return out.raw[:n]

    def key(self, data: bytes, more: bool) -> None:
        _HOST.lib.strobe_key(self._buf(), bytes(data), len(data), int(more))

    def append_messages(self, items) -> None:
        """merlin append_message over (label, message) pairs, in one call."""
        buf = b"".join(struct.pack("<I", len(label)) + label + struct.pack("<I", len(msg)) + msg
                       for label, msg in items)
        _HOST.lib.strobe_append_messages(self._buf(), buf, len(items))

    def rekey_witnesses(self, label: bytes, witnesses: bytes, wlen: int, count: int) -> None:
        """merlin rekey_with_witness_bytes over ``count`` witnesses of
        ``wlen`` bytes packed in ``witnesses``, in one call."""
        if len(witnesses) < wlen * count:
            raise ValueError("rekey_witnesses: buffer shorter than count * wlen")
        _HOST.lib.strobe_rekey_witnesses(self._buf(), bytes(label), len(label), bytes(witnesses),
                                    wlen, count)
