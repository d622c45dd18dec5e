"""Backend dispatch onto the XLA lane-matrix pipeline.

A sequence of up to PIPELINE_CHUNK_WINDOWS windows runs as one jitted
call (ops/pipeline.py); a longer one streams fixed-geometry chunks
(ops/chunked.py). Both are bit-identical to the NumPy oracle
(tests/test_pipeline_vs_oracle.py, tests/test_backend_sketch.py).
"""

from __future__ import annotations

import numpy as np

from ..hashers import KmerHasher
from . import pipeline

# beyond this many windows, a sequence streams fixed-geometry chunks
# (ops/chunked.py) instead of building one giant lane matrix
PIPELINE_CHUNK_WINDOWS = 1 << 24

# sketch_records routes >= RECORDS_BATCH_MIN_COUNT records of at most
# RECORDS_BATCH_MAX_BP chars through the batch engine (one launch per
# stride bucket); below that count batching only adds stride padding and
# the ambiguity plane
RECORDS_BATCH_MIN_COUNT = 8
RECORDS_BATCH_MAX_BP = 1 << 20


def _check_params(k: int, w: int, hasher: KmerHasher, mode: str) -> None:
    l = k + w - 1
    if mode == pipeline.MODE_OPEN_SYNCMERS:
        assert w % 2 == 1, "open syncmers require odd w"
    if hasher.canonical:
        assert l % 2 == 1, (
            f"window length l={l} must be odd to determine strand"
        )


def sketch(
    codes_np: np.ndarray,
    k: int,
    w: int,
    hasher: KmerHasher,
    mode: str = pipeline.MODE_MINIMIZERS,
    ambiguous_np: np.ndarray | None = None,
):
    """Positions (or (positions, superkmer indices)) of one sequence."""
    n = int(codes_np.shape[0])
    l = k + w - 1
    # parameter validity is path-independent (the chunked path calls
    # run_chunk directly, which does not re-check)
    _check_params(k, w, hasher, mode)
    if n >= l and (n - l + 1) > PIPELINE_CHUNK_WINDOWS:
        from . import chunked

        return chunked.sketch(
            codes_np, k, w, hasher, mode=mode, ambiguous_np=ambiguous_np,
            chunk_windows=PIPELINE_CHUNK_WINDOWS,
        )
    return pipeline.run_pipeline(
        codes_np, k, w, hasher, mode=mode, ambiguous_np=ambiguous_np
    )


def sketch_records(
    records,
    k: int,
    w: int,
    hasher: KmerHasher,
    mode: str = pipeline.MODE_MINIMIZERS,
    ambiguous=None,
):
    """Sketch many independent sequences; list of per-record results.

    When the list holds many small records (>= RECORDS_BATCH_MIN_COUNT
    records of l..RECORDS_BATCH_MAX_BP chars), those go through the batch
    engine: one launch per stride bucket for the whole set instead of one
    per record. Every other record is sketched on its own. Bit-identical
    to calling sketch() on each record.
    """
    l = k + w - 1
    pipeline.assert_no_superkmer_ambiguity(
        mode, ambiguous is not None and any(a is not None for a in ambiguous))
    _check_params(k, w, hasher, mode)
    amb = list(ambiguous) if ambiguous is not None else [None] * len(records)
    assert len(amb) == len(records), "ambiguous must align with records"
    out = [None] * len(records)
    small = [i for i, r in enumerate(records)
             if l <= len(r) <= RECORDS_BATCH_MAX_BP]
    if len(small) >= RECORDS_BATCH_MIN_COUNT:
        sub_amb = None
        if any(amb[i] is not None for i in small):
            # the batch engine wants a dense list (no None entries)
            sub_amb = [amb[i] if amb[i] is not None
                       else np.zeros(len(records[i]), np.uint8)
                       for i in small]
        res = sketch_batch([records[i] for i in small], k, w, hasher,
                           mode=mode, ambiguous=sub_amb)
        rid, parts = res[0], res[1:]
        counts = np.bincount(rid, minlength=len(small))
        splits = [np.split(p, np.cumsum(counts)[:-1]) for p in parts]
        for j, i in enumerate(small):
            out[i] = (tuple(s[j] for s in splits) if len(splits) > 1
                      else splits[0][j])
    for i, rec in enumerate(records):
        if out[i] is None:
            out[i] = sketch(rec, k, w, hasher, mode=mode, ambiguous_np=amb[i])
    return out


def sketch_batch(
    reads,
    k: int,
    w: int,
    hasher: KmerHasher,
    mode: str = pipeline.MODE_MINIMIZERS,
    ambiguous=None,
):
    """Batched reads: (read_ids, positions[, superkmer indices]).

    All reads of a stride bucket go through one pipeline launch; see
    ops/batch.py. Results are ordered by read and bit-identical to
    sketching each read alone.
    """
    from . import batch

    return batch.sketch_batch(
        reads, k, w, hasher, mode=mode, ambiguous=ambiguous
    )
