"""Device-resident k-mer value extraction (values_u64/u128 at genome scale).

The host path (ops/values.py) gathers (m, k) byte windows in NumPy — fine
for small sketches, but a human-genome sketch is ~5e8 minimizers x k bytes
of random-access gather traffic on one CPU core. Here the sequence lives
on device as a packed 2-bit little-endian u32 word stream (base i at bit
2*i), each value is assembled from 2-3 gathered words with funnel shifts,
and the canonical min(fwd, revcomp) (/root/reference/src/lib.rs:598-612)
is computed with branch-free 2-bit-group reversal — all plain XLA.

Value convention pinned by the reference doc-test
(/root/reference/src/lib.rs:117-129): first base in the LOWEST bits, 2
bits per char; complement is code ^ 2. Bit-identical to ops/values.py by
tests/test_device_values.py.
"""

from __future__ import annotations

import functools

import numpy as np


def words_from_packed_bytes(packed: np.ndarray,
                            pad_words: int = 4) -> np.ndarray:
    """u32 word stream from 2-bit-packed bytes (base i at bits 2*(i%4)).

    The byte packing is already little-endian, so a <u4 view finishes the
    job: base i lands at bit 2*(i % 16) of word i // 16. PackedSeq buffers
    at a byte-aligned offset ARE this layout — zero repacking. `pad_words`
    trailing zero words let gathers at the last positions stay in bounds.
    Bits past the sequence end never leak into values (the top limb is
    masked to 2k bits and lower limbs lie inside the k-mer).
    """
    b = np.ascontiguousarray(packed, np.uint8)
    pad = (-b.size) % 4
    if pad:
        b = np.concatenate([b, np.zeros(pad, np.uint8)])
    w = b.view("<u4")
    return np.concatenate([w, np.zeros(pad_words, np.uint32)])


def pack_words_np(codes_np: np.ndarray, pad_words: int = 4) -> np.ndarray:
    """Host: 2-bit-pack u8 codes into the u32 little-endian word stream."""
    from .. import native

    return words_from_packed_bytes(native.pack_2bit(codes_np), pad_words)


def pack_words_jnp(codes_dev):
    """Device: same packing from a u8 code array already on the device."""
    import jax.numpy as jnp

    n = codes_dev.shape[0]
    pad = (-n) % 16
    if pad:
        codes_dev = jnp.concatenate(
            [codes_dev, jnp.zeros(pad, jnp.uint8)])
    q = codes_dev.reshape(-1, 16).astype(jnp.uint32)
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, :]
    w = (q << shifts).sum(axis=1).astype(jnp.uint32)
    return jnp.concatenate([w, jnp.zeros(4, jnp.uint32)])


def _rev2_u32(x):
    """Reverse the sixteen 2-bit groups of each u32 (group order only)."""
    import jax.numpy as jnp

    U = jnp.uint32
    x = (x >> U(16)) | (x << U(16))
    x = ((x & U(0xFF00FF00)) >> U(8)) | ((x & U(0x00FF00FF)) << U(8))
    x = ((x & U(0xF0F0F0F0)) >> U(4)) | ((x & U(0x0F0F0F0F)) << U(4))
    x = ((x & U(0xCCCCCCCC)) >> U(2)) | ((x & U(0x33333333)) << U(2))
    return x


def values_limbs_jnp(words, positions, k: int, canonical: bool = False):
    """(m, L) u32 limbs of the k-mer values at `positions` (L = ceil(2k/32)).

    Pure jnp on an already-on-device word stream: usable standalone under
    jit or composed into device-resident pipelines. Limb j holds value
    bits [32j, 32j+32), first base lowest — so (lo | hi << 32) reproduces
    ops/values.py exactly.
    """
    import jax.numpy as jnp

    U = jnp.uint32
    assert 1 <= k <= 64, "2-bit values support k <= 64 (u128 limbs)"
    L = -(-2 * k // 32)
    wi = (positions >> U(4)).astype(jnp.int32)      # word of base p
    sh = ((positions & U(15)) * U(2)).astype(U)     # bit within the word
    g = [jnp.take(words, wi + j, mode="clip") for j in range(L + 1)]

    def funnel(a, b):
        hi = jnp.where(sh == U(0), U(0), b << ((U(32) - sh) & U(31)))
        return (a >> sh) | hi

    limbs = [funnel(g[j], g[j + 1]) for j in range(L)]
    top_bits = 2 * k - 32 * (L - 1)
    if top_bits < 32:
        limbs[-1] = limbs[-1] & U((1 << top_bits) - 1)
    if not canonical:
        return jnp.stack(limbs, axis=-1)
    # revcomp: complement each 2-bit code (^2 == XOR the odd bits), then
    # reverse the k groups: rev2 each limb in swapped order leaves the
    # value in the TOP 2k of 32L bits; realign with a static right shift
    comp = [(x ^ U(0xAAAAAAAA)) for x in limbs]
    if top_bits < 32:
        comp[-1] = comp[-1] & U((1 << top_bits) - 1)
    r = [_rev2_u32(comp[L - 1 - j]) for j in range(L)] + [U(0) * limbs[0]]
    S = 32 * L - 2 * k
    if S == 0:
        rc = r[:L]
    else:
        rc = [(r[j] >> U(S)) | (r[j + 1] << U(32 - S)) for j in range(L)]
    # lexicographic min over limbs, top limb down
    take_r = jnp.zeros_like(limbs[0], dtype=bool)
    eq = jnp.ones_like(take_r)
    for j in reversed(range(L)):
        take_r = take_r | (eq & (rc[j] < limbs[j]))
        eq = eq & (rc[j] == limbs[j])
    out = [jnp.where(take_r, rc[j], limbs[j]) for j in range(L)]
    return jnp.stack(out, axis=-1)


@functools.cache
def _jit_values(k: int, canonical: bool):
    import jax

    def f(words, positions):
        return values_limbs_jnp(words, positions, k, canonical)

    return jax.jit(f)  # retraces per (words, positions) shape pair


def _run_device(codes_or_words, positions_np, k: int, canonical: bool):
    """Bucketed jit driver: (m, L) u32 limbs as a NumPy array."""
    import jax.numpy as jnp

    m = int(positions_np.size)
    L = -(-2 * k // 32)
    if m == 0:
        return np.zeros((0, L), np.uint32)
    words = (pack_words_np(codes_or_words)
             if codes_or_words.dtype == np.uint8 else codes_or_words)
    mcap = 1 << (m - 1).bit_length()
    pos = np.zeros(mcap, np.uint32)
    pos[:m] = positions_np
    out = _jit_values(k, canonical)(jnp.asarray(words), jnp.asarray(pos))
    return np.asarray(out[:m])  # device-slice before the host fetch


def kmer_values_u64(codes_np, positions_np, k: int,
                    canonical: bool = False) -> np.ndarray:
    """uint64 values at positions, computed on device (k <= 32).

    `codes_np` may be raw u8 codes (packed host-side via the native
    helper) or an already-packed u32 word stream from pack_words_np.
    """
    assert k <= 32, "values_u64 requires 2*k <= 64"
    limbs = _run_device(codes_np, positions_np, k, canonical)
    v = limbs[:, 0].astype(np.uint64)
    if limbs.shape[1] > 1:
        v |= limbs[:, 1].astype(np.uint64) << np.uint64(32)
    return v


def kmer_values_u128_limbs(codes_np, positions_np, k: int,
                           canonical: bool = False):
    """(lo, hi) u64 limb arrays at positions, on device (k <= 64)."""
    limbs = _run_device(codes_np, positions_np, k, canonical)
    L = limbs.shape[1]

    def u64(j):
        if j >= L:
            return np.zeros(limbs.shape[0], np.uint64)
        v = limbs[:, j].astype(np.uint64)
        if j + 1 < L:
            v |= limbs[:, j + 1].astype(np.uint64) << np.uint64(32)
        return v

    return u64(0), u64(2)
