"""Resident device daemon: one process owns the GPU and stays warm.

A process that drives the card pays, once, for the kernels' build or load
(``ops/cuda_build.py``), a CUDA context, and each shape's device instance
with its resident generator tables (``utils/warmup.py``). The daemon pays
that once and keeps it; every other process (serving workers, CLIs, batch
jobs) connects over a Unix socket and meets warm shapes on its FIRST
request. The client imports no module that touches ``torch.cuda`` (it does
not import torch at all) and never initializes CUDA.

The reference is a single-process Rust library with no analog
(reference src/lib.rs); this is deployment infrastructure.

Security, where the JAX package's daemon differs by design:

* No shared key and no shared path. The daemon works in a private
  directory (mode 0700; ``$XDG_RUNTIME_DIR/quisquis-daemon`` where that is
  set, else ``quisquis-daemon-<uid>`` under the temp dir, or the directory
  of an explicit ``--socket``), refuses to start if that directory is open
  to group or others, and writes a fresh 32-byte random key to a key file
  of mode 0600 there at every start. The client reads the key from the
  same path; ``multiprocessing.connection``'s HMAC handshake checks it.
* No pickle on the wire. Only ``send_bytes``/``recv_bytes`` frames pass,
  in a tagged binary format on ``utils.serde``'s Writer/Reader: an op tag,
  then u32-counted blobs, scalars and u64s. Nothing received is unpickled
  or evaluated; a frame that does not parse is answered ``error`` and the
  daemon keeps serving.

One request at a time: the card serializes the device programs anyway.
Requests (the op tag, then its fields):

  ping                                        -> ok, device type ("cuda" | "cpu")
  warmup [shape descriptors]                  -> ok, nanoseconds
  shuffle-verify [entry blobs], seed, backend -> ok, count | invalid, message
  range-prove n, [(values, blindings, seed)], backend
                                              -> ok, [(proof bytes, [V bytes])]
  tx-verify [(tx blob, proof blob)], seed     -> ok, count | invalid, message
  shutdown                                    -> ok, "bye"

Shape descriptors are utils.warmup's (("shuffle", m, B), ("range", n, m,
B), ("range-prove", n, m, B), ("shuffle-prove", m, B)).
"""

from __future__ import annotations

import os
import secrets
import stat
import tempfile
import time
from multiprocessing import AuthenticationError
from multiprocessing.connection import Client as _Client
from multiprocessing.connection import Listener as _Listener
from typing import List, Optional, Sequence, Tuple

from .utils.serde import Reader, Writer

#: the longest frame either side reads
MAX_FRAME = 64 << 20
#: AF_UNIX socket paths stop at 107 bytes
MAX_SOCKET_PATH = 107
KEY_BYTES = 32

OPS = ("ping", "warmup", "shuffle-verify", "range-prove", "tx-verify", "shutdown")
STATUS = ("ok", "invalid", "error")


def default_dir() -> str:
    """The daemon's private directory when no --socket is given."""
    runtime = os.environ.get("XDG_RUNTIME_DIR")
    if runtime:
        return os.path.join(runtime, "quisquis-daemon")
    return os.path.join(tempfile.gettempdir(), f"quisquis-daemon-{os.getuid()}")


def default_socket() -> str:
    return os.path.join(default_dir(), "daemon.sock")


def key_file_for(address: str) -> str:
    """The key file beside a socket, unless one is given."""
    return address + ".key"


def private_dir(path: str, create: bool) -> str:
    """`path`, made with mode 0700 when `create` and missing; raises unless
    it is a directory of this user that group and others cannot open."""
    if create:
        os.makedirs(path, mode=0o700, exist_ok=True)
    st = os.lstat(path)
    if not stat.S_ISDIR(st.st_mode) or st.st_uid != os.getuid():
        raise PermissionError(f"{path} is not a directory of this user")
    if st.st_mode & 0o077:
        raise PermissionError(
            f"{path} is open to group or others (mode {stat.S_IMODE(st.st_mode):o}); "
            "the daemon's directory must be 0700")
    return path


def _check_address(address: str) -> None:
    if len(os.fsencode(address)) > MAX_SOCKET_PATH:
        raise ValueError(f"socket path of {len(os.fsencode(address))} bytes; "
                         f"AF_UNIX paths stop at {MAX_SOCKET_PATH}")


def write_key(key_file: str) -> bytes:
    """A fresh random key in a new file of mode 0600 (a stale one removed)."""
    if os.path.lexists(key_file):
        os.unlink(key_file)
    key = secrets.token_bytes(KEY_BYTES)
    fd = os.open(key_file, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(key)
    return key


def read_key(key_file: str) -> bytes:
    with open(key_file, "rb") as f:
        key = f.read()
    if len(key) != KEY_BYTES:
        raise ValueError(f"{key_file}: a key of {len(key)} bytes, not {KEY_BYTES}")
    return key


# ------------------------------------------------------------------ frames

def _text(w: Writer, s: str) -> None:
    w.blob(s.encode())


def _read_text(r: Reader) -> str:
    try:
        return r.blob().decode()
    except UnicodeDecodeError as e:
        raise ValueError(f"text field: {e}") from None


def _opt_blob(w: Writer, b: Optional[bytes]) -> None:
    w.u8(b is not None)
    if b is not None:
        w.blob(b)


def _read_opt_blob(r: Reader) -> Optional[bytes]:
    flag = r.u8()
    if flag > 1:
        raise ValueError(f"optional field flag {flag}")
    return r.blob() if flag else None


def _blobs(w: Writer, items) -> None:
    w.u32(len(items))
    for b in items:
        w.blob(b)


def _read_blobs(r: Reader) -> List[bytes]:
    n = r.u32()
    if n > (len(r.data) - r.off) // 4:
        raise ValueError("declared count exceeds remaining frame bytes")
    return [r.blob() for _ in range(n)]


def encode_request(op: str, *args) -> bytes:
    """A request frame: the op's tag, then its fields (module docstring)."""
    w = Writer()
    w.u8(OPS.index(op))
    if op == "warmup":
        (shapes,) = args
        w.u32(len(shapes))
        for desc in shapes:
            _text(w, desc[0])
            w.u32(len(desc) - 1)
            for d in desc[1:]:
                w.u64(d)
    elif op == "shuffle-verify":
        blobs, seed, backend = args
        _blobs(w, blobs)
        _opt_blob(w, seed)
        _text(w, backend)
    elif op == "range-prove":
        n, values, blindings, seeds, backend = args
        w.u32(n)
        w.u32(len(values))
        for vals, blinds, seed in zip(values, blindings, seeds, strict=True):
            w.u32(len(vals))
            for v in vals:
                w.u64(v)
            w.scalars(blinds)
            w.blob(seed)
        _text(w, backend)
    elif op == "tx-verify":
        pairs, seed = args
        w.u32(len(pairs))
        for txb, pfb in pairs:
            w.blob(txb)
            w.blob(pfb)
        _opt_blob(w, seed)
    return w.bytes_()


def decode_request(frame: bytes) -> Tuple:
    """(op, fields...) of a request frame; raises ValueError unless the
    frame parses whole."""
    r = Reader(frame)
    tag = r.u8()
    if tag >= len(OPS):
        raise ValueError(f"unknown op tag {tag}")
    op = OPS[tag]
    if op == "warmup":
        shapes = []
        for _ in range(r.u32()):
            kind = _read_text(r)
            shapes.append((kind,) + tuple(r.u64() for _ in range(r.u32())))
        out: Tuple = (op, shapes)
    elif op == "shuffle-verify":
        out = (op, _read_blobs(r), _read_opt_blob(r), _read_text(r))
    elif op == "range-prove":
        n = r.u32()
        values, blindings, seeds = [], [], []
        for _ in range(r.u32()):
            values.append([r.u64() for _ in range(r.u32())])
            blindings.append(r.scalars())
            seeds.append(r.blob())
        out = (op, n, values, blindings, seeds, _read_text(r))
    elif op == "tx-verify":
        pairs = []
        for _ in range(r.u32()):
            pairs.append((r.blob(), r.blob()))
        out = (op, pairs, _read_opt_blob(r))
    else:
        out = (op,)
    if not r.done():
        raise ValueError(f"trailing bytes in a {op} frame")
    return out


def encode_reply(status: str, payload) -> bytes:
    """A reply frame: the status tag, then text for "invalid" and "error",
    or the op's result for "ok" (a u64, text, or range proofs)."""
    w = Writer()
    w.u8(STATUS.index(status))
    if isinstance(payload, str):
        w.u8(0)
        _text(w, payload)
    elif isinstance(payload, int):
        w.u8(1)
        w.u64(payload)
    else:   # [(proof bytes, [V bytes])]
        w.u8(2)
        w.u32(len(payload))
        for proof, commitments in payload:
            w.blob(proof)
            w.points(commitments)
    return w.bytes_()


def decode_reply(frame: bytes):
    """(status, payload) of a reply frame."""
    r = Reader(frame)
    status = STATUS[r.u8()]
    kind = r.u8()
    if kind == 0:
        payload = _read_text(r)
    elif kind == 1:
        payload = r.u64()
    else:
        payload = [(r.blob(), r.points()) for _ in range(r.u32())]
    if not r.done():
        raise ValueError("trailing bytes in a reply")
    return status, payload


# ------------------------------------------------------------------ daemon

class DeviceDaemon:
    """The resident device owner. Construct, (optionally) warmup, serve.

    ``device`` is resolved first (the default raises without a GPU); then
    the private directory is checked, the key written and the socket bound.
    """

    def __init__(self, address: Optional[str] = None, key_file: Optional[str] = None,
                 shapes: Sequence[Tuple] = (), device="cuda"):
        from .device import resolve_device

        self.device = resolve_device(device)
        if address is None:
            address = os.path.join(private_dir(default_dir(), create=True), "daemon.sock")
        else:
            private_dir(os.path.dirname(os.path.abspath(address)), create=False)
        _check_address(address)
        self.address = address
        self.key_file = key_file if key_file is not None else key_file_for(address)
        private_dir(os.path.dirname(os.path.abspath(self.key_file)), create=False)
        authkey = write_key(self.key_file)
        if os.path.lexists(address):
            os.unlink(address)
        self._listener = _Listener(address, "AF_UNIX", authkey=authkey)
        self.shapes = [tuple(s) for s in shapes]
        if self.shapes:
            self._do_warmup(self.shapes, verbose=True)

    # ------------------------------------------------------------ handlers

    def _do_warmup(self, shapes, verbose: bool = False) -> None:
        from .utils.warmup import warmup

        warmup(shapes, verbose=verbose, device=self.device)

    def _shuffle_verify(self, blobs: List[bytes], seed: Optional[bytes],
                        backend: str) -> int:
        from .accounts.transcript import Transcript
        from .accounts.verifier import Verifier
        from .shuffle.shuffle import batch_verify_shuffle_proofs
        from .utils import serde

        entries = []
        for blob in blobs:
            proof, statement, inputs, outputs = serde.shuffle_entry_from_bytes(blob)
            entries.append((proof, Verifier(b"Shuffle", Transcript(b"ShuffleProof")),
                            statement, inputs, outputs))
        batch_verify_shuffle_proofs(entries, backend=backend, seed=seed, device=self.device)
        return len(entries)

    def _range_prove(self, n: int, values, blindings, seeds, backend: str):
        from .accounts.transcript import SeededRng, Transcript
        from .bulletproofs.range_proof import RangeProof

        lanes = [(Transcript(b"RangeProof"), list(v), list(b), SeededRng(seed=s))
                 for v, b, s in zip(values, blindings, seeds)]
        out = RangeProof.prove_batch(lanes, n, backend=backend, device=self.device)
        return [(proof.to_bytes(), list(V)) for proof, V in out]

    def _tx_verify(self, pairs, seed: Optional[bytes]) -> int:
        from .transaction.transaction import batch_verify_transactions
        from .utils import serde

        items = [(serde.transaction_from_bytes(t),
                  serde.transaction_proof_from_bytes(p)) for t, p in pairs]
        batch_verify_transactions(items, seed=seed, device=self.device)
        return len(items)

    # --------------------------------------------------------------- serve

    def serve_forever(self) -> None:
        """Accept-and-dispatch loop; returns after a shutdown request. A
        peer that fails the key handshake is dropped and serving goes on."""
        while True:
            try:
                conn = self._listener.accept()
            except (AuthenticationError, EOFError, OSError):
                continue
            try:
                if self._serve_conn(conn):
                    return
            finally:
                conn.close()

    def _reply(self, req: Tuple) -> Tuple[str, object]:
        op = req[0]
        if op == "ping":
            return "ok", self.device.type
        if op == "warmup":
            t0 = time.perf_counter_ns()
            self._do_warmup(req[1])
            return "ok", time.perf_counter_ns() - t0
        if op == "shuffle-verify":
            return "ok", self._shuffle_verify(*req[1:])
        if op == "range-prove":
            return "ok", self._range_prove(*req[1:])
        if op == "tx-verify":
            return "ok", self._tx_verify(*req[1:])
        return "ok", "bye"   # shutdown

    def _serve_conn(self, conn) -> bool:
        """Serve one connection until EOF; True means shutdown requested."""
        while True:
            try:
                frame = conn.recv_bytes(maxlength=MAX_FRAME)
            except (EOFError, OSError):   # closed, or a frame over MAX_FRAME
                return False
            try:
                req = decode_request(frame)
            except Exception as e:  # noqa: BLE001 - a hostile frame: report, keep serving
                conn.send_bytes(encode_reply("error", f"bad frame: {type(e).__name__}: {e}"))
                continue
            try:
                reply = self._reply(req)
            except ValueError as e:          # verification failure
                reply = ("invalid", str(e))
            except Exception as e:           # noqa: BLE001 - report, keep serving
                reply = ("error", f"{type(e).__name__}: {e}")
            conn.send_bytes(encode_reply(*reply))
            if req[0] == "shutdown":
                return True

    def close(self) -> None:
        self._listener.close()
        for path in (self.address, self.key_file):
            if os.path.lexists(path):
                os.unlink(path)


class DeviceClient:
    """Thin client for DeviceDaemon; safe to use from freshly started
    processes: it imports no torch and no CUDA module, and the first
    request runs at the daemon's steady-state latency. It waits for the
    daemon's key file and socket (``retries`` x ``retry_delay`` s)."""

    def __init__(self, address: Optional[str] = None, key_file: Optional[str] = None,
                 retries: int = 50, retry_delay: float = 0.2):
        address = address if address is not None else default_socket()
        key_file = key_file if key_file is not None else key_file_for(address)
        last = None
        for _ in range(retries):
            try:
                self._conn = _Client(address, "AF_UNIX", authkey=read_key(key_file))
                break
            except (FileNotFoundError, ConnectionRefusedError) as e:
                last = e
                time.sleep(retry_delay)
        else:
            raise ConnectionError(f"daemon not reachable at {address}: {last}")

    def roundtrip(self, frame: bytes):
        """Send one frame, return the reply's payload; raises ValueError on
        "invalid" and RuntimeError on "error"."""
        self._conn.send_bytes(frame)
        status, payload = decode_reply(self._conn.recv_bytes(maxlength=MAX_FRAME))
        if status == "ok":
            return payload
        if status == "invalid":
            raise ValueError(payload)
        raise RuntimeError(payload)

    def _call(self, op: str, *args):
        return self.roundtrip(encode_request(op, *args))

    def ping(self) -> str:
        return self._call("ping")

    def warmup(self, shapes: Sequence[Tuple]) -> float:
        """Seconds the daemon took to warm `shapes`."""
        return self._call("warmup", [tuple(s) for s in shapes]) / 1e9

    def verify_shuffles(self, blobs: Sequence[bytes], seed: Optional[bytes] = None,
                        backend: str = "auto") -> int:
        """Verify wire-format shuffle entries; raises ValueError if any
        proof fails. backend: shuffle.batch_verify_shuffle_proofs's ("auto"
        follows the measured rule; "device-batched" forces the warmed
        batched verifier)."""
        return self._call("shuffle-verify", list(blobs), seed, backend)

    def prove_ranges(self, n: int, values, blindings, seeds, backend: str = "auto"):
        """Batched aggregated range proving (RangeProof.prove_batch with
        `backend`); returns [(proof bytes, [V bytes])] per lane."""
        return self._call("range-prove", n, [list(v) for v in values],
                          [list(b) for b in blindings], [bytes(s) for s in seeds], backend)

    def verify_transactions(self, pairs, seed: Optional[bytes] = None) -> int:
        """Verify wire-format (transaction, proof) pairs
        (batch_verify_transactions' "auto")."""
        return self._call("tx-verify", list(pairs), seed)

    def shutdown(self) -> None:
        try:
            self._call("shutdown")
        except (EOFError, ConnectionError, OSError):
            pass

    def close(self) -> None:
        self._conn.close()

    def __enter__(self) -> "DeviceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m quisquis_tpu_torch.daemon [--socket PATH] [--key-file PATH]
    [--device cuda|cpu] [shape ...]``

    Shapes: ``shuffle:m:B`` ``range:n:m:B`` ``range-prove:n:m:B``
    ``shuffle-prove:m:B`` (e.g. ``shuffle:8:16 range:64:16:64``)."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--socket", default=None,
                    help="socket path (its directory must be 0700); default: "
                         "daemon.sock in a private per-user directory")
    ap.add_argument("--key-file", default=None,
                    help="where to write the key (default: the socket path + .key)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("shapes", nargs="*")
    args = ap.parse_args(argv)
    shapes = []
    for s in args.shapes:
        parts = s.split(":")
        shapes.append((parts[0],) + tuple(int(x) for x in parts[1:]))
    daemon = DeviceDaemon(args.socket, args.key_file, shapes=shapes, device=args.device)
    print(f"quisquis daemon ready on {daemon.address} (device {daemon.device.type}, "
          f"{len(shapes)} warm shapes)", flush=True)
    try:
        daemon.serve_forever()
    finally:
        daemon.close()


if __name__ == "__main__":
    main()
