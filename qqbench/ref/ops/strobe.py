"""STROBE-128 duplex construction (the subset used by Merlin transcripts).

A from-scratch implementation of the STROBE lite protocol framework at the
128-bit security level over Keccak-f[1600], exposing exactly the four
operations Merlin uses: ``meta_ad``, ``ad``, ``prf``, ``key``.

Bit-exactness with merlin v2 (the Fiat-Shamir layer of the Rust reference,
reference src/accounts/transcript.rs) is pinned by the known merlin
challenge test vector in tests/test_transcript.py.
"""

from __future__ import annotations

from .keccak import keccak_f1600 as _f1600

STROBE_R = 166

_FLAG_I = 1
_FLAG_A = 1 << 1
_FLAG_C = 1 << 2
_FLAG_T = 1 << 3
_FLAG_M = 1 << 4
_FLAG_K = 1 << 5


class Strobe128:
    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        _f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def clone(self) -> "Strobe128":
        c = object.__new__(Strobe128)
        c.state = bytearray(self.state)
        c.pos = self.pos
        c.pos_begin = self.pos_begin
        c.cur_flags = self.cur_flags
        return c

    # -- internal sponge ops ------------------------------------------------

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        _f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError("cannot continue op with different flags")
            return
        if flags & _FLAG_T:
            raise NotImplementedError("transport ops not supported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (_FLAG_C | _FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    # -- public operations (merlin subset) ---------------------------------

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A | _FLAG_C, more)
        self._overwrite(data)
