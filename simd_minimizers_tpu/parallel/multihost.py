"""Multi-host sketching: each host sketches its genome shard; results merge
bit-exactly (SURVEY.md §2.4, BASELINE config 5).

Scheme (the pod-scale generalization of the reference's 8-lane split and
cross-lane seam dedup, /root/reference/src/collect.rs:252-272):

1. The genome is split into contiguous host shards overlapping by l-1
   chars (so every window is owned by exactly one host).
2. Each host runs the sharded device sketch on its local mesh with its
   global char offset — positions come out sequence-global.
3. Per-host (positions, count) ragged buffers are all-gathered across
   processes (`process_allgather`) or collected by the caller; `merge_shard_positions`
   concatenates and deduplicates at shard seams (adjacent shards emit the
   same minimizer only when it sits in the halo).

Single-process fallbacks make every function testable on one host.
"""

from __future__ import annotations

import numpy as np

from ..hashers import KmerHasher
from ..ops import pipeline
from . import shard


def shard_bounds(n: int, l: int, num_shards: int, shard_id: int) -> tuple[int, int]:
    """Char span [start, end) of a shard incl. the l-1 halo at the end."""
    nw = max(n - l + 1, 0)
    per = -(-nw // num_shards) if nw else 0
    s = min(shard_id * per, nw)
    e = min(s + per, nw)
    if s >= e:
        return 0, 0
    return s, min(e - 1 + l, n)


def merge_shard_positions(shards: list[np.ndarray]) -> np.ndarray:
    """Concatenate per-shard global position lists, dedup at the seams.

    Exact for plain (non-skip-ambiguous) minimizer streams: a shard's last
    output value is always the sel of its last window, and the next
    shard's first output is the sel of its first window, so comparing them
    is exactly the oracle's adjacent dedup. With SKIPPED sentinels in play
    use `merge_adjacent_shards`, which evaluates the true seam windows.
    """
    parts = [s for s in shards if s.size]
    if not parts:
        return np.zeros(0, np.uint32)
    out = [parts[0]]
    for nxt in parts[1:]:
        prev_last = out[-1][-1]
        out.append(nxt[1:] if nxt[0] == prev_last else nxt)
    return np.concatenate(out)


def seam_window_sel(codes_np, k, w, hasher, win: int, ambiguous_np=None) -> int:
    """sel value of ONE global window (host-side, O(l) work)."""
    from ..ops import oracle
    from ..utils.bits import SKIPPED

    l = k + w - 1
    if ambiguous_np is not None and bool(np.any(ambiguous_np[win : win + l])):
        return int(SKIPPED)
    sel = oracle.selected_stream(codes_np[win : win + l], k, w, hasher)
    return int(sel[0]) + win


def merge_adjacent_shards(parts, starts, codes_np, k, w, hasher,
                          ambiguous_np=None, aux=None):
    """Merge per-shard dedup'd minimizer outputs with EXACT seam semantics.

    Each shard computed windows [starts[i], starts[i+1]) with prev=INVALID
    at its first window, so its first output must be dropped iff the
    oracle's adjacent dedup would have dropped window starts[i]: its sel
    equals the previous (global) window's sel. With skip-ambiguous the
    last *output* of the previous shard is not necessarily the previous
    window's sel (trailing SKIPPED runs), so both seam windows are
    re-evaluated directly (O(l) each). `aux` optionally carries a parallel
    plane (super-k-mer indices) dropped in lockstep — the first window
    index of a seam-straddling run is the earlier shard's, matching
    /root/reference/src/collect.rs:106-110.
    """
    from ..utils.bits import SKIPPED

    out = [parts[0]]
    aux_out = [aux[0]] if aux is not None else None
    for i in range(1, len(parts)):
        p = parts[i]
        drop = 0
        if p.size:
            s = int(starts[i])
            w0 = seam_window_sel(codes_np, k, w, hasher, s, ambiguous_np)
            if w0 != int(SKIPPED) and int(p[0]) == w0:
                wprev = seam_window_sel(codes_np, k, w, hasher, s - 1, ambiguous_np)
                drop = 1 if w0 == wprev else 0
        out.append(p[drop:])
        if aux is not None:
            aux_out.append(aux[i][drop:])
    pos = np.concatenate(out) if out else np.zeros(0, np.uint32)
    if aux is not None:
        return pos, np.concatenate(aux_out)
    return pos


def local_shard_sketch(
    codes_np: np.ndarray,
    k: int,
    w: int,
    hasher: KmerHasher,
    num_shards: int,
    shard_id: int,
    mode: str = pipeline.MODE_MINIMIZERS,
    ambiguous_np: np.ndarray | None = None,
    mesh=None,
):
    """This host's contribution: sketch its halo'd shard, global outputs.

    Mode-aware like the reference's single implementation
    (/root/reference/src/lib.rs:427-436, :451-496): returns global
    positions for minimizers, (positions, window indices) for super-k-mers,
    and global window indices for syncmers, all through the sharded XLA
    pipeline on this process's devices (shard.sharded_sketch).
    """
    pipeline.assert_no_superkmer_ambiguity(mode, ambiguous_np is not None)
    l = k + w - 1
    n = int(codes_np.shape[0])
    empty = np.zeros(0, np.uint32)
    s, e = shard_bounds(n, l, num_shards, shard_id)
    if e <= s:
        return (empty, empty) if mode == pipeline.MODE_SUPERKMERS else empty
    local = codes_np[s:e]
    local_amb = ambiguous_np[s:e] if ambiguous_np is not None else None
    mesh = mesh or shard.default_mesh(local_only=True)
    res = shard.sharded_sketch(local, k, w, hasher, mode=mode,
                               ambiguous_np=local_amb, mesh=mesh)
    off = np.uint32(s)
    if mode == pipeline.MODE_SUPERKMERS:
        pos, idx = res
        return (pos + off).astype(np.uint32), (idx + off).astype(np.uint32)
    return (res + off).astype(np.uint32)


def _allgather_ragged_planes(
    planes: list[np.ndarray], nproc: int
) -> list[list[np.ndarray]]:
    """All-gather same-count ragged uint32 planes: per-plane process lists.

    Pads to the max count and exchanges a single stacked (nplanes, cap)
    buffer plus one counts vector — process_allgather is a full
    cross-process barrier, so planes that move in lockstep (e.g. the super-k-mer
    positions + window-index pair) must share one exchange, not pay one
    barrier each.
    """
    from jax.experimental import multihost_utils

    size = planes[0].size
    assert all(p.size == size for p in planes), "planes must move in lockstep"
    all_cnts = multihost_utils.process_allgather(
        np.asarray([size], np.int64))  # (nproc, 1)
    cap = max(int(all_cnts.max()), 1)
    buf = np.full((len(planes), cap), 0xFFFFFFFF, np.uint32)
    for i, p in enumerate(planes):
        buf[i, :size] = p
    all_bufs = multihost_utils.process_allgather(buf)  # (nproc, nplanes, cap)
    return [
        [all_bufs[p, i, : int(all_cnts[p, 0])] for p in range(nproc)]
        for i in range(len(planes))
    ]


def _allgather_ragged(mine: np.ndarray, nproc: int) -> list[np.ndarray]:
    """All-gather one ragged uint32 array: returns the per-process list."""
    return _allgather_ragged_planes([mine], nproc)[0]


def _merge_mode_shards(parts, starts, codes_np, k, w, hasher, mode,
                       ambiguous_np=None, aux=None):
    """Mode-aware merge of per-shard outputs into the global result."""
    empty = np.zeros(0, np.uint32)
    if mode in (pipeline.MODE_CLOSED_SYNCMERS, pipeline.MODE_OPEN_SYNCMERS):
        # syncmer outputs are window indices; shards own disjoint window
        # ranges, so a plain concat is exact
        return np.concatenate(parts) if parts else empty
    if mode == pipeline.MODE_SUPERKMERS:
        return merge_adjacent_shards(parts, starts, codes_np, k, w, hasher,
                                     ambiguous_np, aux=aux)
    return merge_adjacent_shards(parts, starts, codes_np, k, w, hasher,
                                 ambiguous_np)


def multihost_sketch(
    codes_np: np.ndarray,
    k: int,
    w: int,
    hasher: KmerHasher,
    mode: str = pipeline.MODE_MINIMIZERS,
    ambiguous_np: np.ndarray | None = None,
):
    """Whole-genome sketch across all JAX processes, in every mode.

    Call identically on every host (after jax.distributed.initialize);
    each host sketches its shard on its local devices, shards all-gather
    across processes, and every host returns the identical global result:
    positions, (positions, super-k-mer window indices), or syncmer window
    indices — with `ambiguous_np` the N-containing windows are skipped
    (/root/reference/src/lib.rs:451-496). On a single process this
    degrades to the local sharded sketch.
    """
    import jax

    nproc = jax.process_count()
    pid = jax.process_index()
    mine = local_shard_sketch(codes_np, k, w, hasher, nproc, pid, mode=mode,
                              ambiguous_np=ambiguous_np)
    if nproc == 1:
        return mine
    l = k + w - 1
    starts = [shard_bounds(int(codes_np.shape[0]), l, nproc, p)[0]
              for p in range(nproc)]
    if mode == pipeline.MODE_SUPERKMERS:
        parts, aux = _allgather_ragged_planes([mine[0], mine[1]], nproc)
    else:
        parts = _allgather_ragged(mine, nproc)
        aux = None
    return _merge_mode_shards(parts, starts, codes_np, k, w, hasher, mode,
                              ambiguous_np, aux=aux)
