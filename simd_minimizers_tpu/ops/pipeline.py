"""Data-parallel array pipeline (pure jnp / XLA).

This is the data-parallel reformulation of the reference's sequential
streaming design (SURVEY.md §7), computed on a fixed-shape lane matrix so
the compiled XLA graph is independent of sequence length:

- lane layout          -> R rows of C owned windows with l-1 char halos
                          (the data-parallel form of the reference's 8-lane
                          split, src/lib.rs:29-30, src/sliding_min.rs:238-243).
- rolling ntHash       -> windowed XOR of per-position rotated table values
                          from one per-row prefix-XOR scan; the rolling
                          recurrence h' = rotl(h,1) ^ ... (reference
                          bench/src/nthash.rs:90) distributes over XOR, so
                          h[i] = rotr( P[i+k] ^ P[i], i )  with
                          P = prefix-xor of u[p] = rotl(T[s[p]], p + off).
- two-stacks sliding min -> block prefix/suffix minima: reshape each row's
                          key stream to (blocks, w), cummin left and right,
                          combine  win[i] = min(suffix[i], prefix[i+w-1])
                          (the parallel form of src/sliding_min.rs:269-284).
- 16-bit position trick -> the reference's packed (hash_top16 | pos16)
                          single-value compare (src/sliding_min.rs:104-106)
                          carried over directly, but wrap-free: the packed
                          index is the in-row kmer COLUMN (< 2^16 always),
                          with the row base re-attached after the min
                          (layout.window_min_cols_packed) — no periodic
                          rebase (src/sliding_min.rs:245-252) needed.
- canonical strand      -> windowed #TG counts from per-row prefix sums
                          (src/canonical.rs:12-31).
- dedup + compaction    -> keep-mask + prefix-sum ranks + butterfly
                          left-pack (the shuffle-LUT compaction of
                          src/intrinsics/dedup.rs done the XLA way).
                          Single-shot/streamed paths compact per ROW
                          (log2(C) stages, compact_rows) and concatenate
                          rows on the host; device-composed paths
                          (device_driver, shard_map bodies) use the global
                          flat butterfly (compact_flat).

All comparisons use only the top 16 bits of the hash with
leftmost/rightmost tie-breaking, bit-identically to the reference.
Chunk-to-chunk state (the previous raw window value for dedup seams) is a
single u32, so arbitrarily long sequences stream through fixed-size chunks
(see ops/chunked.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import compile_cache_dir
from ..hashers import KmerHasher
from ..utils.bits import SKIPPED as _SKIPPED_NP
from .layout import (
    _hillis_steele,
    build_lane_matrix,
    butterfly_pack,
    butterfly_pack_rows,
    butterfly_pack_rows_packed,
    cumsum_rows_carry,
    window_min_cols_packed,
    windowed_sum,
    windowed_xor,
)

# through jax.config, so it also holds when JAX was imported (and read
# its environment) before this package
if not jax.config.jax_compilation_cache_dir:
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

U32 = jnp.uint32
INVALID_INT = 0xFFFF_FFFF
SKIPPED_INT = int(_SKIPPED_NP)
# numpy scalars (not jnp) so importing the module never touches a device
TOP16 = np.uint32(0xFFFF_0000)
INVALID = np.uint32(INVALID_INT)
SKIPPED = np.uint32(SKIPPED_INT)

MODE_MINIMIZERS = "minimizers"
MODE_SUPERKMERS = "superkmers"
MODE_CLOSED_SYNCMERS = "closed_syncmers"
MODE_OPEN_SYNCMERS = "open_syncmers"


def assert_no_superkmer_ambiguity(mode: str, has_ambiguity: bool) -> None:
    """Shared entry-point rule: super-k-mers x ambiguity mask is
    unrepresentable in the reference (/root/reference/src/lib.rs:498-503);
    every layer rejects it identically rather than computing something
    subtly different."""
    assert not (mode == MODE_SUPERKMERS and has_ambiguity), (
        "super-k-mers cannot be combined with an ambiguity mask "
        "(unrepresentable in the reference, src/lib.rs:498-503)"
    )

# Default lane geometry: C owned windows per row. Halo overhead is
# (l-1)/C; C=4096 keeps it <1% for typical l while rows stay cache-sized.
DEFAULT_C = 4096


def _rotl(x: jnp.ndarray, r) -> jnp.ndarray:
    """Rotate-left uint32 by r (static int, or uint32 array in 0..31)."""
    if isinstance(r, int):
        r %= 32
        if r == 0:
            return x
        return (x << U32(r)) | (x >> U32(32 - r))
    r = r.astype(U32) % U32(32)
    left = x << r
    right = jnp.where(r == 0, U32(0), x >> (U32(32) - r))
    return left | right


def _local_pos(R: int, S: int, C: int) -> jnp.ndarray:
    """(R, S) uint32 grid of chunk-local positions p = r*C + j."""
    r = jax.lax.broadcasted_iota(jnp.int32, (R, S), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (R, S), 1)
    return (r * C + j).astype(U32)


def nt_like_kmer_hashes_2d(vals, comp_vals, k: int, rot_offset: int, canonical: bool, C: int):
    """XOR-rolling kmer hashes on the lane matrix.

    vals/comp_vals: (R, S) uint32 per-position table values.
    Returns (R, S - k + 1) uint32 hashes of kmers starting at each local
    position (fwd, xor'd with the revcomp-kmer hash when canonical).
    """
    R, S = vals.shape
    p = _local_pos(R, S, C)
    u = _rotl(vals, (p + U32(rot_offset)) % U32(32))
    X = windowed_xor(u, k)  # (R, S - k + 1)
    i = _local_pos(R, S - k + 1, C) % U32(32)
    h = _rotl(X, (U32(32) - i) % U32(32))  # rotr by kmer index
    if canonical:
        # revcomp-kmer hash: char at local pos p contributes
        # rotl(T[comp(s[p])], (i + k - 1 - p) + off); factor out i.
        ur = _rotl(comp_vals, (U32(k - 1 + rot_offset) - p) % U32(32))
        Xr = windowed_xor(ur, k)
        h = h ^ _rotl(Xr, i)
    return h


def antilex_kmer_hashes_2d(M, k: int, canonical: bool):
    """~(first min(k,16) chars packed MSB-first); canonical = fwd ^ rc."""
    R, S = M.shape
    nk = S - k + 1
    c = (M & U32(3)).astype(U32)
    la = jnp.zeros((R, nk), dtype=U32)
    for j in range(min(k, 16)):
        la = la | (c[:, j : j + nk] << U32(30 - 2 * j))
    h = ~la
    if canonical:
        cc = c ^ U32(2)
        ra = jnp.zeros((R, nk), dtype=U32)
        for j in range(min(k, 16)):
            ra = ra | (cc[:, k - 1 - j : k - 1 - j + nk] << U32(30 - 2 * j))
        h = h ^ (~ra)
    return h


def kmer_hashes_2d(M: jnp.ndarray, hasher, C: int) -> jnp.ndarray:
    """uint32 kmer hashes on the lane matrix; dispatches on hasher kind."""
    k = hasher.k
    if hasher.kind == "antilex":
        return antilex_kmer_hashes_2d(M, k, hasher.canonical)
    if hasher.kind == "nt":
        table = jnp.asarray(hasher.table, dtype=U32)
        c = (M & jnp.uint8(3)).astype(jnp.int32)
        vals = jnp.take(table, c)
        comp_vals = jnp.take(table, c ^ 2) if hasher.canonical else None
        return nt_like_kmer_hashes_2d(vals, comp_vals, k, hasher.rot_offset, hasher.canonical, C)
    if hasher.kind == "mul":
        mc = jnp.asarray(hasher.mul_const, dtype=U32)
        cu = M.astype(U32)
        vals = (cu + U32(1)) * mc
        comp_vals = ((cu ^ U32(2)) + U32(1)) * mc if hasher.canonical else None
        return nt_like_kmer_hashes_2d(vals, comp_vals, k, hasher.rot_offset, hasher.canonical, C)
    raise ValueError(f"unknown hasher kind {hasher.kind}")


def window_lr_min_2d(hv: jnp.ndarray, w: int, C: int, want_right: bool):
    """Per-row sliding-window minimum positions with exact tie semantics.

    hv: (R, NKr) TOP16-masked hashes, NKr = C + w - 1 kmers per row
    (invalid kmers = 0xFFFFFFFF). Returns (R, C) uint32 chunk-local
    positions r*C + col of each window's leftmost minimum, and rightmost
    when requested. Single-plane packed-position min (the reference's
    16-bit trick, layout.window_min_cols_packed) — half the planes and a
    quarter of the per-stage ops of the two-plane lexicographic compare.
    """
    R = hv.shape[0]
    rowbase = (jax.lax.broadcasted_iota(jnp.int32, (R, C), 0) * C).astype(U32)
    lcol = window_min_cols_packed(hv, w, right_tie=False)
    lpos = rowbase + lcol.astype(U32)
    rpos = None
    if want_right:
        rcol = window_min_cols_packed(hv, w, right_tie=True)
        rpos = rowbase + rcol.astype(U32)
    return lpos, rpos


def windowed_counts_2d(bits: jnp.ndarray, l: int) -> jnp.ndarray:
    """Windowed sums of 0/1 over length-l windows per row: (R, S-l+1) int32."""
    return windowed_sum(bits, l)


def compact_flat(values: jnp.ndarray, keep: jnp.ndarray, R: int, C: int):
    """Stream compaction of a flat (R*C,) stream.

    Butterfly left-pack (log2(R*C) roll+select stages), no scatter.
    Returns (buffer[R*C] front-packed with INVALID tail, count int32)."""
    keep2 = keep.reshape(R, C)
    rank = cumsum_rows_carry(keep2.astype(jnp.int32))  # inclusive
    count = rank[-1, -1]
    i = jax.lax.broadcasted_iota(jnp.int32, (R, C), 0) * C + jax.lax.broadcasted_iota(
        jnp.int32, (R, C), 1
    )
    shift = i - (rank - 1)
    out = butterfly_pack(values.reshape(R, C), shift, ~keep2)
    return out.reshape(R * C), count.astype(jnp.int32)


def compact_rows(planes, keep2, row_local_of=None):
    """Row-LOCAL stream compaction: each row front-packs its kept elements.

    planes: list of (R, C) uint32 arrays sharing one keep mask. Returns
    (packed planes, per-row counts (R,) int32). log2(C) butterfly stages
    instead of log2(R*C) — the cross-row concatenation is a cheap host
    (or caller) step, since row outputs are already in flat order.

    With `row_local_of` = (localize, globalize) and a single plane, the
    butterfly runs on ONE packed u32 plane ((shift << 16) | local_value,
    both fields < 2^16).
    """
    keep_i = keep2.astype(jnp.int32)
    rank = _hillis_steele(keep_i, axis=1)  # inclusive per-row
    counts = rank[:, -1]
    j = jax.lax.broadcasted_iota(jnp.int32, keep2.shape, 1)
    shift = jnp.where(keep2, j - (rank - 1), 0)
    if row_local_of is not None and len(planes) == 1:
        localize, globalize = row_local_of
        x = jnp.where(
            keep2,
            (localize(planes[0]) & U32(0xFFFF))
            | (shift.astype(U32) << U32(16)),
            U32(0xFFFF))
        out = globalize(butterfly_pack_rows_packed(x, keep2.shape[1]) & U32(0xFFFF))
        return [out], counts
    return butterfly_pack_rows(planes, shift, ~keep2), counts


def rows_to_flat(rows_np: np.ndarray, counts_np: np.ndarray) -> np.ndarray:
    """Host-side concat of row-packed outputs (flat order == global order)."""
    parts = [rows_np[r, : int(c)] for r, c in enumerate(counts_np) if c]
    if not parts:
        return np.zeros(0, np.uint32)
    return np.concatenate(parts)


def selected_window_stream_2d(codes, n, offset, k, w, hasher, C, R, ambiguous=None):
    """Per-window selected minimizer positions for one chunk.

    codes: uint8[FLAT] padded so that (R-1)*C + S chars exist (S = C+l-1);
    n: true chunk char count (traced); offset: global position of the
    chunk's first char (traced uint32).

    Returns (sel_flat[R*C] uint32 global positions | SKIPPED | INVALID,
             valid_flat[R*C] bool, widx_local_flat[R*C] int32).
    """
    l = k + w - 1
    S = C + l - 1
    M = build_lane_matrix(codes, R, C, S)
    h = kmer_hashes_2d(M, hasher, C)  # (R, C + w - 1)
    hv = h & TOP16
    kpos = _local_pos(R, C + w - 1, C)
    # kmers beyond the true chunk end never win
    hv = jnp.where(kpos.astype(jnp.int32) <= n - k, hv, INVALID)
    lpos, rpos = window_lr_min_2d(hv, w, C, want_right=hasher.canonical)
    if hasher.canonical:
        tg = (M.astype(jnp.int32) >> 1) & 1
        cnt = windowed_counts_2d(tg, l)  # (R, C)
        sel = jnp.where(2 * cnt > l, lpos, rpos)
    else:
        sel = lpos
    sel = sel + offset.astype(U32)
    if ambiguous is not None:
        Ma = build_lane_matrix(ambiguous, R, C, S)
        ambi = windowed_counts_2d(Ma, l) > 0
        sel = jnp.where(ambi, SKIPPED, sel)
    widx = _local_pos(R, C, C).astype(jnp.int32).reshape(R * C)
    valid = widx <= n - l
    sel = jnp.where(valid, sel.reshape(R * C), INVALID)
    return sel, valid, widx


def _pipeline_chunk(codes, n, offset, prev_raw, ambiguous, k, w, hasher, mode, skip_ambiguous, C, R):
    sel, valid, widx = selected_window_stream_2d(
        codes, n, offset, k, w, hasher, C, R, ambiguous if skip_ambiguous else None
    )
    gw = widx.astype(U32) + offset.astype(U32)  # global window indices
    # raw stream value of the chunk's last valid window (dedup seam state)
    nw_valid = jnp.maximum(n - (k + w - 1) + 1, 1)
    last_raw = sel[jnp.minimum(nw_valid - 1, sel.shape[0] - 1)]
    if mode in (MODE_CLOSED_SYNCMERS, MODE_OPEN_SYNCMERS):
        if mode == MODE_OPEN_SYNCMERS:
            is_sync = sel == gw + U32(w // 2)
        else:
            is_sync = (sel == gw) | (sel == gw + U32(w - 1))
        keep = valid & is_sync & (sel != SKIPPED)
        out, count = compact_flat(gw, keep, R, C)
        return out, count, last_raw
    prev = jnp.concatenate([prev_raw.reshape(1), sel[:-1]])
    keep = valid & (sel != prev)
    if skip_ambiguous:
        keep = keep & (sel != SKIPPED)
    if mode == MODE_SUPERKMERS:
        out, count = compact_flat(sel, keep, R, C)
        idx, _ = compact_flat(gw, keep, R, C)
        return out, idx, count, last_raw
    out, count = compact_flat(sel, keep, R, C)
    return out, count, last_raw


def _pipeline_chunk_rows(codes, n, offset, prev_raw, ambiguous, k, w, hasher,
                         mode, skip_ambiguous, C, R):
    """Like _pipeline_chunk but with row-local compaction (compact_rows):
    returns ((R, C) packed rows..., per-row counts, last_raw). The caller
    concatenates rows (rows_to_flat) — the fast path for single-shot and
    host-streamed runs, skipping the global-cumsum + flat butterfly."""
    sel, valid, widx = selected_window_stream_2d(
        codes, n, offset, k, w, hasher, C, R, ambiguous if skip_ambiguous else None
    )
    gw = widx.astype(U32) + offset.astype(U32)
    nw_valid = jnp.maximum(n - (k + w - 1) + 1, 1)
    last_raw = sel[jnp.minimum(nw_valid - 1, sel.shape[0] - 1)]
    sel2 = sel.reshape(R, C)
    gw2 = gw.reshape(R, C)
    # row-local packing: kept values lie in [rowbase, rowbase + C + l), so
    # value - rowbase fits 16 bits for any C <= 32768
    rowbase = (
        jax.lax.broadcasted_iota(jnp.int32, (R, C), 0) * C
    ).astype(U32) + offset.astype(U32)
    row_local = (lambda v: v - rowbase, lambda v: v + rowbase)
    if mode in (MODE_CLOSED_SYNCMERS, MODE_OPEN_SYNCMERS):
        if mode == MODE_OPEN_SYNCMERS:
            is_sync = sel == gw + U32(w // 2)
        else:
            is_sync = (sel == gw) | (sel == gw + U32(w - 1))
        keep = (valid & is_sync & (sel != SKIPPED)).reshape(R, C)
        (out,), counts = compact_rows([gw2], keep, row_local)
        return out, counts, last_raw
    prev = jnp.concatenate([prev_raw.reshape(1), sel[:-1]])
    keep = valid & (sel != prev)
    if skip_ambiguous:
        keep = keep & (sel != SKIPPED)
    keep = keep.reshape(R, C)
    if mode == MODE_SUPERKMERS:
        (out, idx), counts = compact_rows([sel2, gw2], keep)
        return out, idx, counts, last_raw
    (out,), counts = compact_rows([sel2], keep, row_local)
    return out, counts, last_raw


@functools.partial(
    jax.jit,
    static_argnames=("k", "w", "mode", "skip_ambiguous", "hasher_key", "C", "R",
                     "rows"),
)
def _jit_chunk(codes, n, offset, prev_raw, ambiguous, table, mul_const,
               *, k, w, mode, skip_ambiguous, hasher_key, C, R, rows=False):
    kind, canonical, rot_offset = hasher_key
    hasher = TracedHasher(kind, k, canonical, rot_offset, table, mul_const)
    fn = _pipeline_chunk_rows if rows else _pipeline_chunk
    return fn(
        codes, n, offset, prev_raw, ambiguous, k, w, hasher, mode, skip_ambiguous, C, R
    )


class TracedHasher:
    """Hasher view whose table/const are traced arrays (jit-friendly)."""

    def __init__(self, kind, k, canonical, rot_offset, table, mul_const):
        self.kind = kind
        self.k = k
        self.canonical = canonical
        self.rot_offset = rot_offset
        self.table = table
        self.mul_const = mul_const


def hasher_jit_args(hasher: KmerHasher):
    """(static key, traced table, traced mul const) for a host hasher."""
    key = (hasher.kind, hasher.canonical, getattr(hasher, "rot_offset", 0))
    table = np.asarray(getattr(hasher, "table", np.zeros(4, np.uint32)), np.uint32)
    mul_const = np.uint32(getattr(hasher, "mul_const", 0))
    return key, table, mul_const


def lane_geometry(n: int, l: int, C: int = DEFAULT_C) -> tuple[int, int]:
    """Pick (C, R): C owned windows per row, R rows (power-of-two bucketed)."""
    nw = max(n - l + 1, 1)
    if nw < C:
        C = max(16, 1 << (nw - 1).bit_length())
        return C, 1
    R = -(-nw // C)
    R = 1 << (R - 1).bit_length()  # bucket to limit recompiles
    return C, R


def flat_length(C: int, R: int, l: int) -> int:
    """Padded char-array length the lane matrix build requires."""
    halo = l - 1
    nblocks = -(-halo // C) if halo else 0
    return (R + nblocks) * C


def run_chunk(
    codes_np: np.ndarray,
    k: int,
    w: int,
    hasher: KmerHasher,
    mode: str = MODE_MINIMIZERS,
    ambiguous_np: np.ndarray | None = None,
    offset: int = 0,
    prev_raw: int = INVALID_INT,
    C: int = DEFAULT_C,
    rows: bool = False,
):
    """Run one chunk on device.

    Returns device (out, [idx,] count, last_raw); with rows=True the out
    planes are (R, C) row-packed and count is per-row (see compact_rows /
    rows_to_flat)."""
    l = k + w - 1
    n = int(codes_np.shape[0])
    Cg, R = lane_geometry(n, l, C)
    FLAT = flat_length(Cg, R, l)
    codes = np.zeros(FLAT, dtype=np.uint8)
    codes[:n] = codes_np
    ambiguous = np.zeros(FLAT, dtype=np.uint8)
    skip_ambiguous = ambiguous_np is not None
    if skip_ambiguous:
        ambiguous[:n] = ambiguous_np
    key, table, mul_const = hasher_jit_args(hasher)
    return _jit_chunk(
        jnp.asarray(codes),
        jnp.int32(n),
        jnp.uint32(offset),
        jnp.uint32(prev_raw),
        jnp.asarray(ambiguous),
        jnp.asarray(table),
        jnp.asarray(mul_const),
        k=k,
        w=w,
        mode=mode,
        skip_ambiguous=skip_ambiguous,
        hasher_key=key,
        C=Cg,
        R=R,
        rows=rows,
    )


def run_pipeline(
    codes_np: np.ndarray,
    k: int,
    w: int,
    hasher: KmerHasher,
    mode: str = MODE_MINIMIZERS,
    ambiguous_np: np.ndarray | None = None,
):
    """Single-call host wrapper: run one chunk, slice to the real count.

    Returns positions (uint32 np array), or (positions, superkmer indices).
    For sequences larger than device memory use ops.chunked.sketch.
    """
    l = k + w - 1
    n = int(codes_np.shape[0])
    if mode == MODE_OPEN_SYNCMERS:
        assert w % 2 == 1, "open syncmers require odd w"
    if hasher.canonical:
        assert l % 2 == 1, f"window length l={l} must be odd to determine strand"
    empty = np.zeros(0, dtype=np.uint32)
    if n < l:
        return (empty, empty) if mode == MODE_SUPERKMERS else empty
    res = run_chunk(codes_np, k, w, hasher, mode, ambiguous_np, rows=True)
    if mode == MODE_SUPERKMERS:
        out, idx, counts, _ = res
        cnts = np.asarray(counts)
        return rows_to_flat(np.asarray(out), cnts), rows_to_flat(np.asarray(idx), cnts)
    out, counts, _ = res
    return rows_to_flat(np.asarray(out), np.asarray(counts))
