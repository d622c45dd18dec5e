"""Batched-read sketching: flat slot packing with ambiguous padding.

The answer to the reference's short-sequence workload
(/root/reference/bench/src/bin/paper.rs:61-115): instead of paying the
streaming warm-up per read, reads are laid end-to-end in one flat char
stream at a per-batch `stride` (read i owns chars [i*stride, i*stride+len)),
and every padding char is marked AMBIGUOUS. Windows that touch padding are
SKIPPED by the existing ambiguity machinery, so reads never interact:
no window spans two reads, the dedup chain restarts after each SKIPPED gap,
and read attribution is `pos // stride` on the host. The whole batch then
runs through the XLA lane-matrix pipeline in one launch per stride bucket
— there is no per-slot state on device at all, so batch size is unbounded
and reads may be arbitrarily long (a >C-char read just spans several lane
rows).

Strides are bucketed to a 3-bit mantissa (values m * 2^e, 8 <= m < 16) to
bound recompiles; padding waste is < 12.5% (typically ~6%).

Outputs are ordered by read and bit-identical to running each read alone
(enforced by tests/test_batch.py against the NumPy oracle).
"""

from __future__ import annotations

import numpy as np

from ..hashers import KmerHasher
from . import backend as _backend
from . import pipeline
from .pipeline import (
    MODE_MINIMIZERS,
    MODE_OPEN_SYNCMERS,
    MODE_SUPERKMERS,
)

# max chars per launch: the pipeline materializes a launch as (R, C)
# lane-matrix planes, so the cap matches the memory bound backend.sketch
# enforces for single sequences
MAX_LAUNCH_CHARS = _backend.PIPELINE_CHUNK_WINDOWS


def _stride_bucket(x: int) -> int:
    """Smallest value >= x of the form m * 2^e with 8 <= m < 16."""
    if x <= 8:
        return 8
    e = x.bit_length() - 4
    return ((x + (1 << e) - 1) >> e) << e


def _fill_slots(reads, ambs, stride: int, need: int):
    """(codes, amb) flat uint8 buffers: read i at [i*stride, i*stride+len),
    ambiguous everywhere a read char isn't (so padding windows are SKIPPED)."""
    B = len(reads)
    codes = np.zeros(need, np.uint8)
    amb = np.ones(need, np.uint8)
    lens = [len(r) for r in reads]
    L0 = lens[0] if B else 0
    cview = codes[: B * stride].reshape(B, stride)
    aview = amb[: B * stride].reshape(B, stride)
    if B and all(ln == L0 for ln in lens):  # uniform length: vectorized fill
        cview[:, :L0] = np.asarray(reads, dtype=np.uint8).reshape(B, L0)
        aview[:, :L0] = (
            np.asarray(ambs, dtype=np.uint8).reshape(B, L0) if ambs is not None else 0
        )
    else:
        for i, rd in enumerate(reads):
            cview[i, : lens[i]] = rd
            aview[i, : lens[i]] = ambs[i] if ambs is not None else 0
    return codes, amb


def _launch_pipeline(codes, amb, nw, k, w, hasher, mode):
    l = k + w - 1
    n = nw + l - 1  # windows in [0, nw) need chars up to nw + l - 2
    res = pipeline.run_pipeline(codes[:n], k, w, hasher, mode=mode,
                                ambiguous_np=amb[:n])
    if mode == MODE_SUPERKMERS:
        return res
    return res, None


def sketch_batch(
    reads,
    k: int,
    w: int,
    hasher: KmerHasher,
    mode: str = MODE_MINIMIZERS,
    ambiguous=None,
):
    """Sketch a batch of reads; one pipeline launch per stride bucket.

    reads: list of per-read uint8 code arrays (2-bit DNA codes or raw text
    bytes), or a (B, L) uint8 matrix of equal-length reads.

    Returns (read_ids, positions) with positions local to each read;
    (read_ids, positions, window_indices) for super-k-mers; syncmer modes
    return (read_ids, window_indices). Ordered by read, then position —
    bit-identical to running every read on its own.
    """
    l = k + w - 1
    if mode == MODE_OPEN_SYNCMERS:
        assert w % 2 == 1, "open syncmers require odd w"
    if hasher.canonical:
        assert l % 2 == 1, f"window length l={l} must be odd to determine strand"
    if isinstance(reads, np.ndarray) and reads.ndim == 2:
        reads = list(np.asarray(reads, dtype=np.uint8))
    else:
        reads = [np.asarray(r, dtype=np.uint8).ravel() for r in reads]
    if ambiguous is not None:
        ambiguous = [np.asarray(a, dtype=np.uint8).ravel() for a in ambiguous]

    # group eligible reads (len >= l) by stride bucket; stride > len so at
    # least one ambiguous padding char separates consecutive reads
    groups: dict[int, list[int]] = {}
    for i, rd in enumerate(reads):
        if len(rd) >= l:
            groups.setdefault(_stride_bucket(len(rd) + 1), []).append(i)

    rid_parts, pos_parts, idx_parts = [], [], []
    emit_idx = mode == MODE_SUPERKMERS
    for stride, idxs in sorted(groups.items()):
        per_launch = max(MAX_LAUNCH_CHARS // stride, 1)
        for s0 in range(0, len(idxs), per_launch):
            sub = idxs[s0 : s0 + per_launch]
            sub_reads = [reads[i] for i in sub]
            sub_amb = [ambiguous[i] for i in sub] if ambiguous is not None else None
            B = len(sub)
            nw = B * stride
            codes, amb = _fill_slots(sub_reads, sub_amb, stride, nw + l)
            out, idx = _launch_pipeline(codes, amb, nw, k, w, hasher, mode)
            src = idx if emit_idx else out
            slot = src // np.uint32(stride)
            rid_parts.append(np.asarray(sub, np.uint32)[slot])
            pos_parts.append(out - slot * np.uint32(stride))
            if emit_idx:
                idx_parts.append(idx - slot * np.uint32(stride))

    empty = np.zeros(0, np.uint32)
    rid = np.concatenate(rid_parts) if rid_parts else empty
    pos = np.concatenate(pos_parts) if pos_parts else empty
    order = np.argsort(rid, kind="stable")
    rid, pos = rid[order], pos[order]
    if emit_idx:
        idx = (np.concatenate(idx_parts) if idx_parts else empty)[order]
        return rid, pos, idx
    return rid, pos
