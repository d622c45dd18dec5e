"""Differential tests: JAX/XLA pipeline == NumPy oracle, bit-exactly.

Mirrors the reference's exhaustive differential strategy
(/root/reference/src/test.rs:24-51) with a compile-budget-conscious
(k, w) matrix: every mode (minimizers, canonical, syncmers, super-kmers,
skip-ambiguous) and every hasher is compared against the oracle on random
sequences of assorted lengths and slice offsets.
"""

import numpy as np
import pytest

from simd_minimizers_tpu.hashers import AntiLexHasher, MulHasher, NtHasher
from simd_minimizers_tpu.ops import oracle, pipeline
from simd_minimizers_tpu.seq.packed import PackedNSeqVec, PackedSeqVec
from simd_minimizers_tpu.utils.bits import SKIPPED

RNG = np.random.default_rng(0x5EED)
LENS = [0, 1, 10, 100, 1023, 2048]
KW = [(1, 1), (1, 5), (5, 7), (21, 11), (31, 5), (19, 19), (33, 32), (64, 3)]


@pytest.fixture(scope="module")
def base_seq():
    return PackedSeqVec.random(2048, RNG)


def _lens_for(l):
    return [n for n in LENS if n >= l] + [l, l + 1]


@pytest.mark.parametrize("k,w", KW)
def test_fwd_minimizers(base_seq, k, w):
    h = NtHasher(k)
    for n in _lens_for(k + w - 1):
        off = int(RNG.integers(0, 4))
        codes = base_seq.slice(off, min(off + n, 2048)).codes()
        want = oracle.collect_and_dedup(oracle.selected_stream(codes, k, w, h)) if len(codes) >= k + w - 1 else np.zeros(0, np.uint32)
        got = pipeline.run_pipeline(codes, k, w, h)
        np.testing.assert_array_equal(got, want, err_msg=f"k={k} w={w} n={n}")


@pytest.mark.parametrize("k,w", [(5, 7), (21, 11), (19, 19), (2, 2)])
@pytest.mark.parametrize("hasher_cls", [NtHasher, MulHasher, AntiLexHasher])
def test_canonical_minimizers(base_seq, k, w, hasher_cls):
    if (k + w - 1) % 2 == 0:
        pytest.skip("l must be odd")
    h = hasher_cls(k, canonical=True)
    for n in _lens_for(k + w - 1):
        codes = base_seq.slice(0, min(n, 2048)).codes()
        want = oracle.collect_and_dedup(oracle.selected_stream(codes, k, w, h)) if len(codes) >= k + w - 1 else np.zeros(0, np.uint32)
        got = pipeline.run_pipeline(codes, k, w, h)
        np.testing.assert_array_equal(got, want, err_msg=f"k={k} w={w} n={n}")


@pytest.mark.parametrize("k,w", [(5, 7), (21, 11)])
@pytest.mark.parametrize("canonical", [False, True])
def test_superkmers(base_seq, k, w, canonical):
    h = NtHasher(k, canonical=canonical)
    codes = base_seq.codes()
    sel = oracle.selected_stream(codes, k, w, h)
    want_pos, want_idx = oracle.collect_and_dedup_with_index(sel)
    got_pos, got_idx = pipeline.run_pipeline(codes, k, w, h, mode=pipeline.MODE_SUPERKMERS)
    np.testing.assert_array_equal(got_pos, want_pos)
    np.testing.assert_array_equal(got_idx, want_idx)


@pytest.mark.parametrize("k,w", [(5, 7), (11, 7), (7, 11)])
@pytest.mark.parametrize("open_", [False, True])
@pytest.mark.parametrize("canonical", [False, True])
def test_syncmers(base_seq, k, w, open_, canonical):
    if canonical and (k + w - 1) % 2 == 0:
        pytest.skip("l must be odd")
    h = NtHasher(k, canonical=canonical)
    mode = pipeline.MODE_OPEN_SYNCMERS if open_ else pipeline.MODE_CLOSED_SYNCMERS
    for n in [200, 2048]:
        codes = base_seq.slice(0, n).codes()
        want = oracle.collect_syncmers(oracle.selected_stream(codes, k, w, h), w, open_)
        got = pipeline.run_pipeline(codes, k, w, h, mode=mode)
        np.testing.assert_array_equal(got, want, err_msg=f"k={k} w={w} n={n}")


@pytest.mark.parametrize("k,w", [(5, 7), (21, 11)])
def test_skip_ambiguous(k, w):
    n = 1024
    codes = RNG.integers(0, 4, n).astype(np.uint8)
    ambiguous = RNG.random(n) < 0.01
    h = NtHasher(k, canonical=True)
    sel = oracle.selected_stream(codes, k, w, h, ambiguous=ambiguous)
    want = oracle.collect_and_dedup(sel, skip_sentinel=True)
    got = pipeline.run_pipeline(codes, k, w, h, ambiguous_np=ambiguous.astype(np.uint8))
    np.testing.assert_array_equal(got, want)
    assert not np.any(got == SKIPPED)


def test_seeded_hasher(base_seq):
    codes = base_seq.codes()
    h = NtHasher(21, canonical=True, seed=101010)
    want = oracle.collect_and_dedup(oracle.selected_stream(codes, 21, 11, h))
    got = pipeline.run_pipeline(codes, 21, 11, h)
    np.testing.assert_array_equal(got, want)
    # different seed -> different sampling (overwhelmingly likely)
    h2 = NtHasher(21, canonical=True, seed=7)
    got2 = pipeline.run_pipeline(codes, 21, 11, h2)
    assert got2.shape != got.shape or not np.array_equal(got2, got)


def _want(codes, k, w, h, mode=pipeline.MODE_MINIMIZERS, ambiguous=None):
    sel = oracle.selected_stream(codes, k, w, h, ambiguous=ambiguous)
    if mode == pipeline.MODE_SUPERKMERS:
        return oracle.collect_and_dedup_with_index(sel)
    if mode in (pipeline.MODE_CLOSED_SYNCMERS, pipeline.MODE_OPEN_SYNCMERS):
        return oracle.collect_syncmers(sel, w, mode == pipeline.MODE_OPEN_SYNCMERS)
    return oracle.collect_and_dedup(sel, skip_sentinel=ambiguous is not None)


@pytest.mark.parametrize("k,w,hcls,canonical,mode,amb_rate,n", [
    (5, 7, NtHasher, False, pipeline.MODE_MINIMIZERS, 0, 20000),
    (21, 11, NtHasher, False, pipeline.MODE_MINIMIZERS, 0, 20000),
    (31, 5, NtHasher, False, pipeline.MODE_MINIMIZERS, 0, 20000),
    (19, 19, NtHasher, False, pipeline.MODE_MINIMIZERS, 0, 20000),
    (21, 11, NtHasher, True, pipeline.MODE_MINIMIZERS, 0, 20000),
    (21, 11, MulHasher, True, pipeline.MODE_MINIMIZERS, 0, 20000),
    (21, 11, AntiLexHasher, True, pipeline.MODE_MINIMIZERS, 0, 20000),
    (5, 7, NtHasher, True, pipeline.MODE_SUPERKMERS, 0, 12000),
    (11, 7, NtHasher, False, pipeline.MODE_CLOSED_SYNCMERS, 0, 12000),
    (11, 7, NtHasher, False, pipeline.MODE_OPEN_SYNCMERS, 0, 12000),
    (5, 7, NtHasher, True, pipeline.MODE_MINIMIZERS, 0.01, 12000),
])
def test_multirow_modes(k, w, hcls, canonical, mode, amb_rate, n):
    """Every mode through backend.sketch on inputs spanning several lane
    rows (row halos, multi-row compaction, power-of-two row bucketing)."""
    from simd_minimizers_tpu.ops import backend

    rng = np.random.default_rng(0xF0D + k * 31 + w)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    amb = (rng.random(n) < amb_rate).astype(np.uint8) if amb_rate else None
    h = hcls(k, canonical=canonical)
    got = backend.sketch(codes, k, w, h, mode=mode, ambiguous_np=amb)
    want = _want(codes, k, w, h, mode=mode, ambiguous=amb)
    if mode == pipeline.MODE_SUPERKMERS:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "kind,canonical,k,rot",
    [
        ("nt", True, 21, 0),
        ("nt", False, 21, 0),
        ("nt", True, 5, 0),
        ("nt", True, 31, 7),
        ("nt", True, 1, 3),
        ("nt", True, 64, 13),
        ("nt", False, 33, 31),
        ("mul", True, 21, 0),
        ("mul", False, 19, 5),
        ("mul", True, 33, 11),
        ("antilex", True, 9, 0),
    ],
)
def test_windowed_hash_matches_oracle(kind, canonical, k, rot):
    """The lane-matrix windowed hash (prefix-XOR of rotated table values,
    rotated back by the k-mer's position) equals the oracle's per-k-mer
    hash at every row and column, for every kind, strand, k and rotation
    offset."""
    import jax.numpy as jnp

    from simd_minimizers_tpu.ops.layout import build_lane_matrix

    rng = np.random.default_rng(k * 131 + rot)
    h = {"nt": NtHasher, "mul": MulHasher, "antilex": AntiLexHasher}[kind](
        k, canonical=canonical)
    h.rot_offset = rot
    R, C = 4, 256
    S = C + k - 1 + 40  # a halo of at most one extra row block
    flat = rng.integers(0, 4, (R + 1) * C, dtype=np.uint8)
    M = build_lane_matrix(jnp.asarray(flat), R, C, S)
    got = np.asarray(pipeline.kmer_hashes_2d(M, h, C))
    want = h.hash_kmers_np(flat)
    for r in range(R):
        np.testing.assert_array_equal(got[r], want[r * C : r * C + S - k + 1],
                                      err_msg=f"row {r}")
