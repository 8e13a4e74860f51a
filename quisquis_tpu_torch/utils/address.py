"""Network addresses (mirrors reference src/util/address.rs:17-279).

Wire format: [magic byte || 64-byte pk (gr||grsk) || 4-byte Keccak-256
checksum], with hex and base58 encodings.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from ..ops import exact as ex
from ..ops.keccak import keccak256
from ..primitives.keys import RistrettoPublicKey

_B58_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"


def b58_encode(data: bytes) -> str:
    num = int.from_bytes(data, "big")
    out = ""
    while num:
        num, rem = divmod(num, 58)
        out = _B58_ALPHABET[rem] + out
    pad = 0
    for b in data:
        if b == 0:
            pad += 1
        else:
            break
    return "1" * pad + out


def b58_decode(s: str) -> bytes:
    num = 0
    for ch in s:
        num = num * 58 + _B58_ALPHABET.index(ch)
    raw = num.to_bytes((num.bit_length() + 7) // 8, "big") if num else b""
    pad = 0
    for ch in s:
        if ch == "1":
            pad += 1
        else:
            break
    return b"\x00" * pad + raw


class Network(Enum):
    Mainnet = "Mainnet"
    Testnet = "Testnet"

    def as_u8(self, addr_type: "AddressType") -> int:
        table = {
            (Network.Mainnet, AddressType.Standard): 12,
            (Network.Mainnet, AddressType.Contract): 24,
            (Network.Testnet, AddressType.Standard): 44,
            (Network.Testnet, AddressType.Contract): 66,
        }
        return table[(self, addr_type)]

    @staticmethod
    def from_u8(byte: int) -> "Network":
        if byte in (12, 24):
            return Network.Mainnet
        if byte in (44, 66):
            return Network.Testnet
        raise ValueError("Error::InvalidNteworkByte")


class AddressType(Enum):
    Standard = "Standard"
    Contract = "Contract"

    @staticmethod
    def from_byte(byte: int, net: Network) -> "AddressType":
        table = {
            (Network.Mainnet, 12): AddressType.Standard,
            (Network.Mainnet, 24): AddressType.Contract,
            (Network.Testnet, 44): AddressType.Standard,
            (Network.Testnet, 66): AddressType.Contract,
        }
        try:
            return table[(net, byte)]
        except KeyError:
            raise ValueError("Error::InvalidAddressTypeMagicByte")


@dataclass(frozen=True)
class Address:
    network: Network
    addr_type: AddressType
    public_key: RistrettoPublicKey

    @staticmethod
    def standard(network: Network, public_key: RistrettoPublicKey) -> "Address":
        return Address(network, AddressType.Standard, public_key)

    @staticmethod
    def contract(network: Network, public_key: RistrettoPublicKey) -> "Address":
        return Address(network, AddressType.Contract, public_key)

    def as_bytes(self) -> bytes:
        body = bytes([self.network.as_u8(self.addr_type)]) + self.public_key.as_bytes()
        checksum = keccak256(body)[:4]
        return body + checksum

    @staticmethod
    def from_bytes(data: bytes) -> "Address":
        if len(data) != 69:
            raise ValueError("Invalid Address Length")
        network = Network.from_u8(data[0])
        addr_type = AddressType.from_byte(data[0], network)
        gr, grsk = data[1:33], data[33:65]
        if ex.ristretto_decode(gr) is None or ex.ristretto_decode(grsk) is None:
            raise ValueError("InvalidPoint")
        if keccak256(data[:65])[:4] != data[65:69]:
            raise ValueError("Invalid Checksum")
        return Address(network, addr_type, RistrettoPublicKey(gr, grsk))

    def as_hex(self) -> str:
        return self.as_bytes().hex()

    @staticmethod
    def from_hex(s: str) -> "Address":
        return Address.from_bytes(bytes.fromhex(s))

    def as_base58(self) -> str:
        return b58_encode(self.as_bytes())

    @staticmethod
    def from_base58(s: str) -> "Address":
        return Address.from_bytes(b58_decode(s))
