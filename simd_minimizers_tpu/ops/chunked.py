"""Streaming driver for sequences of arbitrary length.

Splits a sequence into fixed-geometry chunks (so XLA compiles exactly one
program), runs each chunk on device, and stitches results. The only
cross-chunk state is the previous raw window value (a single u32) used for
the adjacent-dedup seam — the streaming analog of the reference's cross-lane
boundary dedup (/root/reference/src/collect.rs:252-272).

Positions are sequence-global uint32; total length is capped at 2^32 chars
per sequence, like the reference (src/sliding_min.rs:96-99). Shard longer
inputs at a higher level (see parallel/).
"""

from __future__ import annotations

import numpy as np

from ..hashers import KmerHasher
from . import pipeline


def sketch(
    codes_np: np.ndarray,
    k: int,
    w: int,
    hasher: KmerHasher,
    mode: str = pipeline.MODE_MINIMIZERS,
    ambiguous_np: np.ndarray | None = None,
    chunk_windows: int = 1 << 24,
):
    """Compute minimizer/syncmer positions for one (possibly huge) sequence.

    Returns positions, or (positions, superkmer indices) for superkmers.
    """
    l = k + w - 1
    n = int(codes_np.shape[0])
    assert n < (1 << 32), "split inputs over 4G chars at the sharding layer"
    empty = np.zeros(0, dtype=np.uint32)
    if n < l:
        return (empty, empty) if mode == pipeline.MODE_SUPERKMERS else empty
    nw = n - l + 1
    if nw <= chunk_windows:
        return pipeline.run_pipeline(codes_np, k, w, hasher, mode, ambiguous_np)

    outs, idxs = [], []
    prev_raw = pipeline.INVALID_INT
    for s in range(0, nw, chunk_windows):
        e = min(s + chunk_windows, nw)
        chars_end = min(e - 1 + l, n)
        chunk = codes_np[s:chars_end]
        amb = ambiguous_np[s:chars_end] if ambiguous_np is not None else None
        res = pipeline.run_chunk(
            chunk, k, w, hasher, mode, amb, offset=s, prev_raw=prev_raw, rows=True
        )
        if mode == pipeline.MODE_SUPERKMERS:
            out, idx, counts, last_raw = res
            cnts = np.asarray(counts)
            outs.append(pipeline.rows_to_flat(np.asarray(out), cnts))
            idxs.append(pipeline.rows_to_flat(np.asarray(idx), cnts))
        else:
            out, counts, last_raw = res
            outs.append(pipeline.rows_to_flat(np.asarray(out), np.asarray(counts)))
        prev_raw = int(last_raw)
    if mode == pipeline.MODE_SUPERKMERS:
        return np.concatenate(outs), np.concatenate(idxs)
    return np.concatenate(outs)
