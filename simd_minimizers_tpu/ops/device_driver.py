"""Single-dispatch whole-sequence driver.

Runs the entire sequence in ONE jitted call, with no host round trip
between chunks: a `lax.fori_loop` over fixed-geometry chunks, each chunk
running the full minimizer pipeline, with compacted outputs appended to a
global buffer via `dynamic_update_slice` (chunk c's INVALID tail is
overwritten by chunk c+1, which starts exactly at the accumulated count).

Input is 2-bit packed (4 bases/byte) and unpacked on device — 0.25 B/bp of
host->device traffic, matching the reference's PackedSeqVec storage.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..hashers import KmerHasher
from . import pipeline
from .pipeline import (
    INVALID,
    MODE_CLOSED_SYNCMERS,
    MODE_MINIMIZERS,
    MODE_OPEN_SYNCMERS,
    MODE_SUPERKMERS,
    TracedHasher,
    U32,
    hasher_jit_args,
)


def unpack_2bit(packed: jnp.ndarray) -> jnp.ndarray:
    """uint8 packed bytes (4 bases each, base i at bits 2*(i%4)) -> codes."""
    shifts = jnp.arange(4, dtype=jnp.uint8) * jnp.uint8(2)
    return ((packed[:, None] >> shifts[None, :]) & jnp.uint8(3)).reshape(-1)


@functools.partial(
    jax.jit,
    static_argnames=("k", "w", "mode", "skip_ambiguous", "hasher_key", "C", "R", "nchunks"),
)
def _device_sketch(packed, n, ambiguous_packed, table, mul_const,
                   *, k, w, mode, skip_ambiguous, hasher_key, C, R, nchunks):
    """Whole-sequence sketch in one dispatch.

    packed: uint8[ceil(FLAT/4) * nchunk-strided...] — actually uint8 packed
    array covering nchunks * CW + halo chars (CW = R*C). Returns
    (out buffer, [superkmer idx buffer,] total count, last_raw).
    """
    kind, canonical, rot_offset = hasher_key
    hasher = TracedHasher(kind, k, canonical, rot_offset, table, mul_const)
    CW = R * C  # windows (and chars) advanced per chunk
    FLAT = pipeline.flat_length(C, R, k + w - 1)
    cap = nchunks * CW + CW  # slack: each chunk writes a full CW block
    out0 = jnp.full(cap, INVALID, U32)
    idx0 = jnp.full(cap if mode == MODE_SUPERKMERS else 1, INVALID, U32)

    # Unpack ONCE up front rather than fusing the strided 2-bit decode into
    # each chunk's lane-matrix build, where XLA may re-materialize it.
    codes_all = unpack_2bit(packed)
    amb_all = unpack_2bit(ambiguous_packed) & jnp.uint8(1) if skip_ambiguous else None

    def body(c, state):
        out, idx, total, prev_raw = state
        s = c * CW  # char & window offset of this chunk
        codes = jax.lax.dynamic_slice(codes_all, (s,), (FLAT,))
        n_loc = jnp.clip(n - s, 0, FLAT)
        amb = None
        if skip_ambiguous:
            amb = jax.lax.dynamic_slice(amb_all, (s,), (FLAT,))
        res = pipeline._pipeline_chunk(
            codes, n_loc, s.astype(U32), prev_raw, amb,
            k, w, hasher, mode, skip_ambiguous, C, R,
        )
        if mode == MODE_SUPERKMERS:
            out_c, idx_c, cnt, last_raw = res
            idx = jax.lax.dynamic_update_slice(idx, idx_c, (total,))
        else:
            out_c, cnt, last_raw = res
        out = jax.lax.dynamic_update_slice(out, out_c, (total,))
        return out, idx, total + cnt, last_raw

    out, idx, total, last_raw = jax.lax.fori_loop(
        0, nchunks, body, (out0, idx0, jnp.int32(0), jnp.asarray(INVALID))
    )
    if mode == MODE_SUPERKMERS:
        return out, idx, total, last_raw
    return out, total, last_raw


def _pack_bits_to_2bit_bytes(bits: np.ndarray) -> np.ndarray:
    """Pack a 0/1 uint8 array using the same 2-bit/byte layout as codes."""
    n = bits.size
    pad = (-n) % 4
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    quads = bits.reshape(-1, 4)
    shifts = (np.arange(4, dtype=np.uint8) * 2)[None, :]
    return np.bitwise_or.reduce((quads << shifts).astype(np.uint8), axis=1)


class DeviceSketcher:
    """Reusable whole-sequence sketcher with fixed chunk geometry.

    One instance = one compiled program; call `sketch` repeatedly on
    sequences up to `nchunks * R * C` windows.
    """

    def __init__(self, k: int, w: int, hasher: KmerHasher | None = None,
                 mode: str = MODE_MINIMIZERS, C: int = 4096, R: int = 1024,
                 nchunks: int = 8, skip_ambiguous: bool = False):
        from ..hashers import default_hasher

        self.k, self.w, self.mode = k, w, mode
        self.C, self.R, self.nchunks = C, R, nchunks
        self.skip_ambiguous = skip_ambiguous
        self.hasher = hasher or default_hasher(k, canonical=False)
        self.key, self.table, self.mul_const = hasher_jit_args(self.hasher)
        self.capacity_chars = nchunks * R * C

    def required_packed_len(self) -> int:
        l = self.k + self.w - 1
        flat = pipeline.flat_length(self.C, self.R, l)
        return ((self.nchunks - 1) * self.R * self.C + flat) // 4 + 1

    def device_inputs(self, codes_np: np.ndarray, ambiguous_np: np.ndarray | None = None):
        """Pack + pad + transfer inputs. Returns (packed, n, amb_packed)."""
        from ..seq.packed import PackedSeqVec

        n = codes_np.shape[0]
        need_b = self.required_packed_len()
        packed = np.zeros(need_b, np.uint8)
        pb = PackedSeqVec.from_codes(codes_np).data
        packed[: pb.size] = pb
        amb = np.zeros(1, np.uint8)
        if self.skip_ambiguous:
            amb = np.zeros(need_b, np.uint8)
            ab = _pack_bits_to_2bit_bytes(ambiguous_np.astype(np.uint8))
            amb[: ab.size] = ab
        return jnp.asarray(packed), jnp.int32(n), jnp.asarray(amb)

    def sketch_device(self, packed_dev, n_dev, amb_dev):
        """Run on already-transferred inputs; returns device arrays."""
        return _device_sketch(
            packed_dev, n_dev, amb_dev,
            jnp.asarray(self.table), jnp.asarray(self.mul_const),
            k=self.k, w=self.w, mode=self.mode,
            skip_ambiguous=self.skip_ambiguous, hasher_key=self.key,
            C=self.C, R=self.R, nchunks=self.nchunks,
        )

    def sketch(self, codes_np: np.ndarray, ambiguous_np: np.ndarray | None = None):
        """End-to-end: host codes -> host positions."""
        l = self.k + self.w - 1
        n = int(codes_np.shape[0])
        empty = np.zeros(0, dtype=np.uint32)
        if n < l:
            return (empty, empty) if self.mode == MODE_SUPERKMERS else empty
        assert n <= self.capacity_chars, "sequence exceeds sketcher capacity"
        res = self.sketch_device(*self.device_inputs(codes_np, ambiguous_np))
        if self.mode == MODE_SUPERKMERS:
            out, idx, total, _ = res
            cnt = int(total)
            return np.asarray(out[:max(cnt, 1)])[:cnt], np.asarray(idx[:max(cnt, 1)])[:cnt]
        out, total, _ = res
        cnt = int(total)
        return np.asarray(out[: max(cnt, 1)])[:cnt]
