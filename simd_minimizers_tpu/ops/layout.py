"""Lane-matrix layout + windowed reductions: the data-parallel
generalization of the reference's 8-lane split.

The reference splits a sequence into 8 SIMD lanes with a w+k-2 character
overlap so every window is owned by exactly one lane
(/root/reference/src/lib.rs:29-30, src/sliding_min.rs:238-243). Here we
generalize to R lanes ("rows") of C owned windows each, laid out as a
(R, C + l - 1) character matrix whose rows overlap by l-1 chars. All
per-position ops then run on fixed-shape 2D arrays (rows = sublanes),
keeping the XLA graph size independent of sequence length.

All sliding-window reductions here use binary doubling over STATIC slices
of the (R, S) matrix — no lax scans and no small trailing axes (whether
cumsum and scatter beat this on the GPU is not measured yet). Windowed
min uses the sparse-table overlap trick (idempotent ops); windowed
xor/sum use the binary decomposition of the window length.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def build_lane_matrix(flat: jnp.ndarray, R: int, C: int, span: int) -> jnp.ndarray:
    """(R, span) matrix with M[r, j] = flat[r*C + j].

    Requires len(flat) >= (R-1)*C + span. Built from `span - C` strided
    column slices plus one contiguous reshape — no gather.
    """
    body = flat[: R * C].reshape(R, C)
    if span <= C:
        return body[:, :span]
    # halo of row r = the next span-C chars after the row body. Built from
    # whole shifted reshapes (contiguous; no strided slices): block b of the
    # halo is flat[(b+1)*C : (b+1)*C + R*C] reshaped to rows.
    h = span - C
    nblocks = -(-h // C)
    assert flat.shape[0] >= (nblocks + R) * C, "flat under-padded for halo build"
    parts = [body]
    for b in range(nblocks):
        width = min(C, h - b * C)
        shifted = flat[(b + 1) * C : (b + 1 + R) * C].reshape(R, C)
        parts.append(shifted[:, :width])
    return jnp.concatenate(parts, axis=1)


def _hillis_steele(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Inclusive prefix-sum along `axis` via doubling (static pad+slice+add).

    log2(n) static shifted adds; whether XLA's native cumsum is faster on
    the GPU is not measured yet.
    """
    n = x.shape[axis]
    d = 1
    while d < n:
        pad = [(0, 0)] * x.ndim
        pad[axis] = (d, 0)
        shifted = jnp.pad(x, pad)[
            tuple(slice(0, n) if a == axis else slice(None) for a in range(x.ndim))
        ]
        x = x + shifted
        d *= 2
    return x


def cumsum_rows_carry(x: jnp.ndarray) -> jnp.ndarray:
    """Global inclusive cumsum of a (R, C) int32 array in row-major order.

    Per-row doubling prefix plus an exclusive scan of row totals — avoids
    giant 1D scans so the compiled graph stays small.
    """
    row = _hillis_steele(x, axis=1)
    totals = row[:, -1]
    carry = _hillis_steele(totals, axis=0) - totals
    return row + carry[:, None]


def _roll_flat_left(x2: jnp.ndarray, d: int) -> jnp.ndarray:
    """Roll a (R, C) array left by d in row-major (flat) order.

    Elements wrap to the end (callers treat the wrapped region as dead).
    Only static slices/concats.
    """
    R, C = x2.shape
    if d % C == 0:
        return jnp.roll(x2, -(d // C), axis=0)
    assert d < C
    down = jnp.roll(x2, -1, axis=0)  # row r+1 (wraps)
    return jnp.concatenate([x2[:, d:], down[:, :d]], axis=1)


def butterfly_pack(vals2: jnp.ndarray, shift2: jnp.ndarray, dead: jnp.ndarray):
    """Left-pack live elements of a (R, C) row-major stream.

    vals2: uint32 values; shift2: int32 left-shift of each live element
    (monotone non-decreasing over live elements in flat order — true for
    compaction shifts i - rank(i)); dead: bool, True where the slot holds
    no live element (those must carry value INVALID = 0xffffffff).

    Classic SIMD stream-compaction butterfly: process shift bits LSB->MSB;
    at stage d an element moves left by d iff bit d of its remaining shift
    is set. Monotone shifts guarantee no collisions. log2(R*C) stages of
    static rolls + selects — no scatter.
    """
    INVALID = jnp.uint32(0xFFFF_FFFF)
    # Dead slots carry shift 0, so "bit d set" doubles as the liveness
    # check: only two planes (value, remaining shift) ride the butterfly.
    x = jnp.where(dead, INVALID, vals2)
    s = jnp.where(dead, 0, shift2)
    total = vals2.shape[0] * vals2.shape[1]
    d = 1
    while d < total:
        xs = _roll_flat_left(x, d)
        ss = _roll_flat_left(s, d)
        take = (ss & d) != 0
        hole = (s & d) != 0  # else-branch only
        x = jnp.where(take, xs, jnp.where(hole, INVALID, x))
        s = jnp.where(take, ss - d, jnp.where(hole, 0, s))
        d *= 2
    return x


def _windowed_fold(x: jnp.ndarray, width: int, op):
    """Per-row fold of `op` over sliding windows of `width`.

    out[r, i] = op(x[r, i], ..., x[r, i + width - 1]); shape (R, S - width + 1).
    Binary doubling: part_d[i] = op(part_{d/2}[i], part_{d/2}[i + d/2]),
    then combine the set bits of `width`.
    """
    S = x.shape[1]
    out_len = S - width + 1
    assert out_len >= 1
    acc = None
    done = 0  # prefix of the window already folded into acc
    part = x  # current partial: op over [i, i + d)
    d = 1
    while True:
        if width & d:
            seg = part[:, done : done + out_len]
            acc = seg if acc is None else op(acc, seg)
            done += d
        if d * 2 > width:
            break
        L = S - 2 * d + 1
        part = op(part[:, :L], part[:, d : d + L])
        d *= 2
    return acc


def windowed_xor(u: jnp.ndarray, k: int) -> jnp.ndarray:
    """Per-row XOR over sliding windows of k chars: (R, S-k+1)."""
    return _windowed_fold(u, k, jnp.bitwise_xor)


def windowed_sum(bits: jnp.ndarray, l: int) -> jnp.ndarray:
    """Per-row int32 sums over sliding windows of l: (R, S-l+1)."""
    return _windowed_fold(bits.astype(jnp.int32), l, jnp.add)


def window_min_cols_packed(hv: jnp.ndarray, w: int, right_tie: bool) -> jnp.ndarray:
    """Per-row sliding-window minimum COLUMNS via the packed-position trick.

    The reference packs positions into the low 16 bits of the compared
    value so one unsigned min realizes the (hash_top16, position) order
    (/root/reference/src/sliding_min.rs:104-106); positions here are the
    in-row kmer columns (wrap-free: column < C + w - 1 < 2^16). For the
    rightmost arm the column is complemented (the `!pos` trick of
    src/sliding_min.rs:190-192). hv must be TOP16-masked (invalid kmers =
    0xFFFFFFFF, which dominates either encoding).

    Returns (R, S - w + 1) int32 columns of each window's minimum.
    """
    R, S = hv.shape
    assert S < (1 << 16), "packed-position min needs columns < 2^16"
    col = jax.lax.broadcasted_iota(jnp.int32, (R, S), 1).astype(jnp.uint32)
    elem = hv | (jnp.uint32(0xFFFF) - col if right_tie else col)
    f = elem
    p = 1
    while p * 2 <= w:
        L = f.shape[1] - p
        f = jnp.minimum(f[:, :L], f[:, p : p + L])
        p *= 2
    C = S - w + 1
    f = jnp.minimum(f[:, :C], f[:, w - p : w - p + C])
    c16 = (f & jnp.uint32(0xFFFF)).astype(jnp.int32)
    return (0xFFFF - c16) if right_tie else c16


def butterfly_pack_rows_packed(x: jnp.ndarray, C: int) -> jnp.ndarray:
    """Single-plane within-row left-pack: x = (shift << 16) | local_value.

    Row-local values (< C + l) and shifts (< C) both fit 16 bits for any
    C <= 32768, so the value and its remaining shift ride one u32 plane —
    half the planes of butterfly_pack_rows. Dead slots carry 0xFFFF
    (shift 0); holes are refilled with it. Same monotone-shift argument
    as butterfly_pack.
    """
    DEAD = jnp.uint32(0xFFFF)
    d = 1
    while d < C:
        xs = jnp.concatenate([x[:, d:], x[:, :d]], axis=1)
        take = ((xs >> jnp.uint32(16)) & jnp.uint32(d)) != 0
        hole = ((x >> jnp.uint32(16)) & jnp.uint32(d)) != 0  # else-branch only
        x = jnp.where(take, xs - jnp.uint32(d << 16), jnp.where(hole, DEAD, x))
        d *= 2
    return x


def butterfly_pack_rows(planes, shift2: jnp.ndarray, dead: jnp.ndarray):
    """Left-pack live elements WITHIN each row independently.

    Same contract as butterfly_pack but shifts never cross rows, so only
    log2(C) stages of within-row rolls are needed (vs log2(R*C) flat
    stages). `planes` is a list of uint32 (R, C) arrays sharing one keep
    mask; returns the packed planes (front of each row holds its kept
    elements in order, INVALID tail).
    """
    INVALID = jnp.uint32(0xFFFF_FFFF)
    xs = [jnp.where(dead, INVALID, v) for v in planes]
    s = jnp.where(dead, 0, shift2)
    C = shift2.shape[1]
    d = 1
    while d < C:
        ss = jnp.concatenate([s[:, d:], s[:, :d]], axis=1)
        take = (ss & d) != 0
        hole = (s & d) != 0  # else-branch only
        xs = [
            jnp.where(take, jnp.concatenate([x[:, d:], x[:, :d]], axis=1),
                      jnp.where(hole, INVALID, x))
            for x in xs
        ]
        s = jnp.where(take, ss - d, jnp.where(hole, 0, s))
        d *= 2
    return xs


