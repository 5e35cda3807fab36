"""Native host code for the signing path: batched RFC 6979 nonces (HMAC
with SHA-256, SM3 or belt-hash), batched SHA-256 and SM3 over messages of
one length, and batched belt-hash over messages of any lengths
(fastcrypt.cpp, the port's own copy of the JAX package's file, unchanged).

The library is built with g++ at first use into build/native/ beside the
package, named by a hash of the source, as the CUDA kernels are
(ops/kernels.py). A failed build raises with the compiler's output; nothing
falls back to another path. Callers send only the shapes the library covers
(qlen == 256, 32-byte digests, no extra data): rfc6979.generate_k_batch and
ecdsa.hash_msgs route the rest to Python.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastcrypt.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "native")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_RFC6979 = {"sha256": "rfc6979_k_sha256_batch", "sm3": "rfc6979_k_sm3_batch",
            "belt": "rfc6979_k_belt_batch"}


def library_path() -> str:
    with open(SOURCE, "rb") as fh:
        key = hashlib.sha256(fh.read() + "\0".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"fastcrypt-{key.hexdigest()[:16]}.so")


def build() -> str:
    """Compile fastcrypt.cpp unless a library of the same source and flags
    is there; returns its path. Raises RuntimeError with g++'s output."""
    so = library_path()
    if os.path.exists(so):
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native signing code needs a C++ compiler")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *GXX_FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed (g++ exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    for name in _RFC6979.values():
        getattr(lib, name).argtypes = [ctypes.c_char_p] * 4 + [ctypes.c_int32]
        getattr(lib, name).restype = None
    for name in ("sha256_batch", "sm3_batch"):
        getattr(lib, name).argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                       ctypes.c_char_p, ctypes.c_int32]
        getattr(lib, name).restype = None
    lib.belt_hash_batch.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                    ctypes.c_char_p, ctypes.c_int32]
    lib.belt_hash_batch.restype = None
    return lib


def rfc6979_k_batch(hashname: str, q: int, xs, h1s) -> list[int]:
    """RFC 6979 k for each (x, h1) with HMAC-`hashname` ("sha256", "sm3" or
    "belt", belt-hash): q of 256 bits, secrets xs in [1, q), 32-byte
    digests h1s."""
    if hashname not in _RFC6979:
        raise ValueError(f"no native RFC 6979 for {hashname}")
    if q.bit_length() != 256:
        raise ValueError("the native RFC 6979 takes a 256-bit q")
    h1s = list(h1s)
    if len(h1s) != len(xs) or any(len(h) != 32 for h in h1s):
        raise ValueError("the native RFC 6979 takes one 32-byte digest per secret")
    B = len(xs)
    out = ctypes.create_string_buffer(32 * B)
    getattr(_lib(), _RFC6979[hashname])(
        q.to_bytes(32, "big"), b"".join(int(x).to_bytes(32, "big") for x in xs),
        b"".join(h1s), out, B)
    raw = out.raw
    return [int.from_bytes(raw[32 * b:32 * b + 32], "big") for b in range(B)]


def _hash_batch(fn_name: str, msgs) -> list[bytes]:
    msgs = list(msgs)
    B = len(msgs)
    msg_len = len(msgs[0]) if msgs else 0
    if any(len(m) != msg_len for m in msgs):
        raise ValueError("the native batch hashes take messages of one length")
    out = ctypes.create_string_buffer(32 * B)
    getattr(_lib(), fn_name)(b"".join(msgs), msg_len, out, B)
    raw = out.raw
    return [raw[32 * b:32 * b + 32] for b in range(B)]


def sha256_batch(msgs) -> list[bytes]:
    """SHA-256 of each message; all messages have one length."""
    return _hash_batch("sha256_batch", msgs)


def sm3_batch(msgs) -> list[bytes]:
    """SM3 of each message; all messages have one length."""
    return _hash_batch("sm3_batch", msgs)


def belt_hash_batch(msgs) -> list[bytes]:
    """belt-hash (STB 34.101.31) of each message; the messages may differ in
    length (one buffer, delimited by B + 1 offsets)."""
    msgs = list(msgs)
    B = len(msgs)
    offs = (ctypes.c_int64 * (B + 1))()
    pos = 0
    for i, m in enumerate(msgs):
        offs[i] = pos
        pos += len(m)
    offs[B] = pos
    out = ctypes.create_string_buffer(32 * B)
    _lib().belt_hash_batch(b"".join(msgs), offs, out, B)
    raw = out.raw
    return [raw[32 * b:32 * b + 32] for b in range(B)]
