"""Native (C++) host helpers, built on first use with graceful fallback.

The compute path is JAX on the accelerator; this package holds the host-side
runtime pieces the reference implements natively (packed-seq's SIMD
packing, the bench crate's needletail FASTA ingestion,
/root/reference/bench/src/lib.rs:51-82): ASCII->2-bit packing, ambiguity
masks, and a one-pass FASTA scanner. Compiled from packseq.cpp with
g++ -O3 -march=native into a cached shared library; if no toolchain is
available every entry point falls back to vectorized NumPy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "packseq.cpp")
_lib = None
_tried = False


def _build_and_load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        from .. import cache_dir

        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        # per-user 0700 cache dir: nobody else can pre-plant the .so
        cache = os.path.join(cache_dir(), f"packseq_{tag}.so")
        if not os.path.exists(cache):
            tmp = cache + f".{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", tmp],
                check=True, capture_output=True,
            )
            os.replace(tmp, cache)
        lib = ctypes.CDLL(cache)
        lib.pack_ascii.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                   ctypes.c_void_p, ctypes.c_void_p]
        lib.pack_2bit.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
        lib.fasta_scan.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_int64]
        lib.fasta_scan.restype = ctypes.c_int64
        lib.kmer_values_u64.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


_IS_ACGT = np.zeros(256, dtype=bool)
for _c in b"ACGTacgt":
    _IS_ACGT[_c] = True


def pack_ascii(ascii_arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(codes, ambiguous) for a uint8 ASCII array."""
    n = ascii_arr.size
    lib = _build_and_load()
    codes = np.empty(n, np.uint8)
    amb = np.empty(n, np.uint8)
    if lib is not None and n:
        ascii_arr = np.ascontiguousarray(ascii_arr, np.uint8)
        lib.pack_ascii(_ptr(ascii_arr), n, _ptr(codes), _ptr(amb))
        return codes, amb
    codes = ((ascii_arr >> 1) & 3).astype(np.uint8)
    amb = (~_IS_ACGT[ascii_arr]).astype(np.uint8)
    return codes, amb


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """4-bases-per-byte packing (base i at bits 2*(i%4))."""
    n = codes.size
    out = np.zeros((n + 3) // 4, np.uint8)
    lib = _build_and_load()
    if lib is not None and n:
        codes = np.ascontiguousarray(codes, np.uint8)
        lib.pack_2bit(_ptr(codes), n, _ptr(out))
        return out
    pad = (-n) % 4
    c = np.concatenate([codes, np.zeros(pad, np.uint8)]) if pad else codes
    quads = c.reshape(-1, 4)
    shifts = (np.arange(4, dtype=np.uint8) * 2)[None, :]
    return np.bitwise_or.reduce((quads << shifts).astype(np.uint8), axis=1)


def fasta_scan(buf: np.ndarray, max_records: int = 1 << 20):
    """One-pass FASTA parse of a uint8 buffer.

    Returns (codes, ambiguous, starts) where starts[i]..starts[i+1] spans
    record i in the concatenated codes/ambiguous arrays.
    """
    lib = _build_and_load()
    n = buf.size
    codes = np.empty(n, np.uint8)
    amb = np.empty(n, np.uint8)
    starts = np.empty(max_records + 1, np.int64)
    if lib is not None:
        buf = np.ascontiguousarray(buf, np.uint8)
        nrec = lib.fasta_scan(_ptr(buf), n, _ptr(codes), _ptr(amb),
                              _ptr(starts), max_records)
        if nrec < 0:
            raise ValueError("too many FASTA records")
        total = int(starts[nrec])
        # views, not copies: total is within ~2% of n for real FASTA
        # (newlines+headers), and copying 2x1 GB at this host's ~100 MB/s
        # memory bandwidth costs ~20 s per genome
        return codes[:total], amb[:total], starts[: nrec + 1].copy()
    # NumPy fallback: line-oriented
    text = buf.tobytes()
    seqs, names = [], []
    cur = []
    for line in text.split(b"\n"):
        line = line.rstrip(b"\r")
        if line.startswith(b">"):
            if cur or names:
                seqs.append(b"".join(cur))
                cur = []
            names.append(line)
        elif line:
            cur.append(line)
    if cur or names:  # a buffer with no data at all has zero records
        seqs.append(b"".join(cur))
    if len(seqs) > len(names):  # headerless
        names = [b""] * len(seqs)
    if names and len(seqs) < len(names):
        seqs.append(b"")
    starts_l = [0]
    codes_l, amb_l = [], []
    for s in seqs:
        arr = np.frombuffer(s, np.uint8)
        c, a = pack_ascii(arr)
        codes_l.append(c)
        amb_l.append(a)
        starts_l.append(starts_l[-1] + arr.size)
    return (
        np.concatenate(codes_l) if codes_l else np.zeros(0, np.uint8),
        np.concatenate(amb_l) if amb_l else np.zeros(0, np.uint8),
        np.asarray(starts_l, np.int64),
    )


def available() -> bool:
    return _build_and_load() is not None


def kmer_values_u64(codes: np.ndarray, positions: np.ndarray, k: int,
                    canonical: bool) -> np.ndarray | None:
    """Packed u64 k-mer values at positions (2-bit codes); None if no
    native library (caller falls back to the NumPy path)."""
    lib = _build_and_load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    positions = np.ascontiguousarray(positions, np.uint32)
    out = np.empty(positions.size, np.uint64)
    lib.kmer_values_u64(_ptr(codes), _ptr(positions),
                        ctypes.c_int64(positions.size), ctypes.c_int64(k),
                        ctypes.c_int(1 if canonical else 0), _ptr(out))
    return out
