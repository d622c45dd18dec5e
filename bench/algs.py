"""Sliding-window-minimum algorithm zoo (the reference bench crate's
ablation set, /root/reference/bench/src/{naive,queue,rescan,split,
jumping}.rs), as instrumented NumPy/Python reference implementations.

These exist for the same reason the reference keeps them: to document and
sanity-check the algorithm space (comparisons per element, output
equivalence), not to be fast. The production pipeline uses a
sparse-table doubling form of the sliding minimum; see
simd_minimizers_tpu/ops/layout.py (window_min_cols_packed).

Problems (reference bench/src/minimizer.rs:11-37):
  A: deduplicated minimizer positions of all windows
  B: per-window minimizer position stream
  C: super-k-mers (position + first window index)
"""

from __future__ import annotations

import collections

import numpy as np


class CmpCounter:
    """Counts comparisons, like the reference's counting harness
    (/root/reference/bench/src/counting.rs:59-94)."""

    def __init__(self):
        self.count = 0

    def less(self, a, b) -> bool:
        self.count += 1
        return a < b


def naive_sliding_min(vals: np.ndarray, w: int, cnt: CmpCounter) -> np.ndarray:
    """O(w) rescan per window (bench/src/naive.rs)."""
    nw = len(vals) - w + 1
    out = np.empty(nw, np.int64)
    for i in range(nw):
        best, bp = vals[i], i
        for j in range(i + 1, i + w):
            if cnt.less(vals[j], best):
                best, bp = vals[j], j
        out[i] = bp
    return out


def queue_sliding_min(vals: np.ndarray, w: int, cnt: CmpCounter) -> np.ndarray:
    """Monotone deque (bench/src/queue.rs)."""
    nw = len(vals) - w + 1
    out = np.empty(nw, np.int64)
    q: collections.deque = collections.deque()  # (pos, val), increasing val
    for i, v in enumerate(vals):
        # strict pop keeps the leftmost element on ties
        while q and cnt.less(v, q[-1][1]):
            q.pop()
        q.append((i, v))
        if q[0][0] <= i - w:
            q.popleft()
        if i >= w - 1:
            out[i - w + 1] = q[0][0]
    return out


def rescan_sliding_min(vals: np.ndarray, w: int, cnt: CmpCounter) -> np.ndarray:
    """Keep the min; rescan the window only when it expires
    (bench/src/rescan.rs)."""
    nw = len(vals) - w + 1
    out = np.empty(nw, np.int64)
    bp = -1
    for i in range(nw):
        if bp < i:
            bp = i
            for j in range(i + 1, i + w):
                if cnt.less(vals[j], vals[bp]):
                    bp = j
        elif cnt.less(vals[i + w - 1], vals[bp]):
            bp = i + w - 1
        out[i] = bp
    return out


def split_sliding_min(vals: np.ndarray, w: int, cnt: CmpCounter) -> np.ndarray:
    """Two-stacks / split: block prefix+suffix minima (bench/src/split.rs;
    the production algorithm, src/sliding_min.rs:269-284)."""
    n = len(vals)
    nw = n - w + 1
    pad = (-n) % w
    v = np.concatenate([vals, np.full(pad, np.iinfo(np.int64).max)])
    blocks = v.reshape(-1, w)
    # suffix minima within blocks (left-biased), prefix minima across
    sfx_pos = np.empty_like(blocks, dtype=np.int64)
    pfx_pos = np.empty_like(blocks, dtype=np.int64)
    for b in range(blocks.shape[0]):
        bp = w - 1
        sfx_pos[b, w - 1] = w - 1
        for j in range(w - 2, -1, -1):
            if not cnt.less(blocks[b, bp], blocks[b, j]):  # ties go left
                bp = j
            sfx_pos[b, j] = bp
        bp = 0
        pfx_pos[b, 0] = 0
        for j in range(1, w):
            if cnt.less(blocks[b, j], blocks[b, bp]):
                bp = j
            pfx_pos[b, j] = bp
    out = np.empty(nw, np.int64)
    for i in range(nw):
        b, phi = divmod(i, w)
        sp = b * w + sfx_pos[b, phi]
        if phi == 0:
            out[i] = sp
        else:
            pp = (b + 1) * w + pfx_pos[b + 1, phi - 1]
            out[i] = pp if cnt.less(v[pp], v[sp]) else sp
    return out


def jumping_minimizers(vals: np.ndarray, w: int, cnt: CmpCounter) -> np.ndarray:
    """Jump to last-min+1; positions only, no per-window stream
    (bench/src/jumping.rs)."""
    n = len(vals)
    out = []
    i = 0
    while i + w <= n:
        bp = i
        for j in range(i + 1, i + w):
            if cnt.less(vals[j], vals[bp]):
                bp = j
        out.append(bp)
        # next window that can change the min starts after bp
        i = bp + 1
    return np.asarray(out, np.int64)


ALGS_B = {
    "naive": naive_sliding_min,
    "queue": queue_sliding_min,
    "rescan": rescan_sliding_min,
    "split": split_sliding_min,
}


def problem_a(vals: np.ndarray, w: int, alg=split_sliding_min) -> np.ndarray:
    """Dedup'd positions (Problem A) from any Problem-B algorithm."""
    sel = alg(vals, w, CmpCounter())
    if sel.size == 0:
        return sel
    keep = np.ones(sel.size, bool)
    keep[1:] = sel[1:] != sel[:-1]
    return sel[keep]


def comparison_counts(n: int = 4096, w: int = 11, seed: int = 0):
    """Comparisons/element for each algorithm (counting.rs experiment)."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 31, n).astype(np.int64)
    res = {}
    for name, alg in ALGS_B.items():
        cnt = CmpCounter()
        alg(vals, w, cnt)
        res[name] = cnt.count / n
    cnt = CmpCounter()
    jumping_minimizers(vals, w, cnt)
    res["jumping"] = cnt.count / n
    return res
