"""Batched Keccak-f[1600] on the device.

The permutation behind the STROBE/merlin transcripts, over a batch axis, so
that B transcripts replay in lockstep. A state is ``[..., 200]`` uint8: the
byte view that STROBE's absorb and squeeze positions need.

:func:`f1600` launches the CUDA kernel (``csrc/keccak_f1600.cu``, through
:mod:`quisquis_tpu_torch.ops.cuda_keccak`) for CUDA tensors and calls
:func:`f1600_plain` for CPU tensors. The plain version holds the 25 lanes as
int64 (torch has no shifts on uint64): 200 bytes viewed as 25 little-endian
words, ``<<`` wraps as it should, and the arithmetic ``>>`` is masked.
Byte for byte the host permutation of :mod:`quisquis_tpu_torch.ops.keccak`.
"""

from __future__ import annotations

import functools

import torch

from .keccak import _ROTATIONS, _ROUND_CONSTANTS

# flat lane index i = x + 5y. rho+pi: dest[y + 5((2x + 3y) % 5)] = rotl(src[x + 5y])
_PI_SRC = [0] * 25
_PI_ROT = [0] * 25
for _x in range(5):
    for _y in range(5):
        _d = _y + 5 * ((2 * _x + 3 * _y) % 5)
        _PI_SRC[_d] = _x + 5 * _y
        _PI_ROT[_d] = _ROTATIONS[_x][_y]
_CHI_1 = [(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)]
_CHI_2 = [(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)]


def _signed(v: int) -> int:
    return v - (1 << 64) if v >> 63 else v


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    def t(values):
        return torch.tensor(values, dtype=torch.int64, device=device)

    rot = t(_PI_ROT)
    rc = t([_signed(c) for c in _ROUND_CONSTANTS])
    iota = torch.zeros((24, 25), dtype=torch.int64, device=device)
    iota[:, 0] = rc
    return {"src": t(_PI_SRC), "rot": rot, "back": (64 - rot) % 64,
            "low": t([(1 << r) - 1 for r in _PI_ROT]),  # rot 0: mask 0
            "chi1": t(_CHI_1), "chi2": t(_CHI_2), "iota": iota}


def _rotl(x: torch.Tensor, r, back, low) -> torch.Tensor:
    """Rotate int64 words left by r bits; low = 2^r - 1 masks the sign bits
    that the arithmetic right shift by back = (64 - r) % 64 drags in."""
    return (x << r) | ((x >> back) & low)


def f1600_plain(state: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on [..., 200] uint8 states, in plain torch."""
    k = _tables(state.device)
    shape = state.shape[:-1]
    a = state.contiguous().view(torch.int64).reshape(-1, 25)
    for rnd in range(24):
        c = a.view(-1, 5, 5)  # [y, x]
        c = c[:, 0] ^ c[:, 1] ^ c[:, 2] ^ c[:, 3] ^ c[:, 4]
        d = torch.roll(c, 1, -1) ^ _rotl(torch.roll(c, -1, -1), 1, 63, 1)
        a = (a.view(-1, 5, 5) ^ d[:, None, :]).reshape(-1, 25)
        b = _rotl(a[:, k["src"]], k["rot"], k["back"], k["low"])
        a = b ^ (~b[:, k["chi1"]] & b[:, k["chi2"]]) ^ k["iota"][rnd]
    return a.contiguous().view(torch.uint8).reshape(*shape, 200)


def f1600(state: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on [..., 200] uint8 states (a new tensor)."""
    from . import cuda_keccak
    return cuda_keccak.f1600(state)
