"""Keccak-f[1600] permutation and Keccak-based hashes.

Host-side sponge primitives used by the transcript layer (STROBE-128 /
Merlin) and by address checksums (Keccak-256, the pre-NIST padding variant
used by the reference's `sha3::Keccak256`,
see reference src/util/address.rs:198-200).

Validated against hashlib's SHA3 implementations in tests (same permutation,
independent implementation). Pure Python: the port's copy keeps no native
fast path.
"""

from __future__ import annotations

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK


def keccak_f1600(state: bytearray) -> None:
    """In-place Keccak-f[1600] on a 200-byte state (little-endian lanes)."""
    lanes = [[0] * 5 for _ in range(5)]
    for x in range(5):
        for y in range(5):
            off = 8 * (x + 5 * y)
            lanes[x][y] = int.from_bytes(state[off:off + 8], "little")

    for rc in _ROUND_CONSTANTS:
        # theta
        c = [lanes[x][0] ^ lanes[x][1] ^ lanes[x][2] ^ lanes[x][3] ^ lanes[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                lanes[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(lanes[x][y], _ROTATIONS[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                lanes[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _MASK)
        # iota
        lanes[0][0] ^= rc

    for x in range(5):
        for y in range(5):
            off = 8 * (x + 5 * y)
            state[off:off + 8] = lanes[x][y].to_bytes(8, "little")


def _sponge(rate: int, data: bytes, pad_byte: int, out_len: int) -> bytes:
    state = bytearray(200)
    # absorb
    pos = 0
    for byte in data:
        state[pos] ^= byte
        pos += 1
        if pos == rate:
            keccak_f1600(state)
            pos = 0
    # pad
    state[pos] ^= pad_byte
    state[rate - 1] ^= 0x80
    keccak_f1600(state)
    # squeeze
    out = bytearray()
    while len(out) < out_len:
        out.extend(state[:min(rate, out_len - len(out))])
        if len(out) < out_len:
            keccak_f1600(state)
    return bytes(out)


def sha3_256(data: bytes) -> bytes:
    return _sponge(136, data, 0x06, 32)


def sha3_512(data: bytes) -> bytes:
    return _sponge(72, data, 0x06, 64)


def keccak256(data: bytes) -> bytes:
    """Legacy Keccak-256 (pad 0x01), as used by `sha3::Keccak256` in Rust."""
    return _sponge(136, data, 0x01, 32)


def shake256(data: bytes, out_len: int) -> bytes:
    return _sponge(136, data, 0x1F, out_len)
