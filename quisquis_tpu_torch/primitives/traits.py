"""Key trait protocols (mirrors reference src/keys.rs:11-126).

The reference defines `SecretKey` and `PublicKey` traits that
`RistrettoSecretKey` / `RistrettoPublicKey` implement; here the same
contracts are expressed as typing.Protocol classes so alternative key
backends can be typechecked against the same surface.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class SecretKey(Protocol):
    """src/keys.rs:11-35."""

    @classmethod
    def random(cls, rng) -> "SecretKey": ...

    @classmethod
    def from_bytes(cls, data: bytes) -> "SecretKey": ...

    def as_bytes(self) -> bytes: ...

    @staticmethod
    def key_length() -> int: ...


@runtime_checkable
class PublicKey(Protocol):
    """src/keys.rs:37-126."""

    @classmethod
    def from_secret_key(cls, sk, rng) -> "PublicKey": ...

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey": ...

    def as_bytes(self) -> bytes: ...

    @staticmethod
    def key_length() -> int: ...

    @staticmethod
    def update_public_key(p, rscalar: int) -> "PublicKey": ...

    @staticmethod
    def verify_public_key_update(u, p, rscalar: int) -> bool: ...

    @staticmethod
    def generate_base_pk() -> "PublicKey": ...

    def verify_keypair(self, sk) -> None: ...

    def sign_msg(self, msg: bytes, sk, label: bytes, rng=None): ...

    def verify_msg(self, msg: bytes, signature, label: bytes) -> None: ...
