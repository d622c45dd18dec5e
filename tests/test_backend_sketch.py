"""backend.sketch (single-call pipeline and chunked streaming) == NumPy
oracle, bit-exactly, on edge geometries and inputs: empty and short
sequences, partly dead lane rows, general text, ASCII DNA, extreme and
large k / w, clustered ambiguity, and chunk seams in every mode."""

import numpy as np
import pytest

from simd_minimizers_tpu.hashers import AntiLexHasher, MulHasher, NtHasher
from simd_minimizers_tpu.ops import backend, chunked, oracle, pipeline

RNG = np.random.default_rng(0xF0D)


def _want(codes, k, w, h, mode=pipeline.MODE_MINIMIZERS, ambiguous=None):
    sel = oracle.selected_stream(codes, k, w, h, ambiguous=ambiguous)
    if mode == pipeline.MODE_SUPERKMERS:
        return oracle.collect_and_dedup_with_index(sel)
    if mode in (pipeline.MODE_CLOSED_SYNCMERS, pipeline.MODE_OPEN_SYNCMERS):
        return oracle.collect_syncmers(sel, w, mode == pipeline.MODE_OPEN_SYNCMERS)
    return oracle.collect_and_dedup(sel, skip_sentinel=ambiguous is not None)


def _assert_same(got, want, mode=pipeline.MODE_MINIMIZERS, msg=""):
    if mode == pipeline.MODE_SUPERKMERS:
        np.testing.assert_array_equal(got[0], want[0], err_msg=msg)
        np.testing.assert_array_equal(got[1], want[1], err_msg=msg)
    else:
        np.testing.assert_array_equal(got, want, err_msg=msg)


def test_sketch_short_and_dead_rows():
    """Inputs shorter than one window are empty; a window count just past
    one row leaves most of the power-of-two row bucket dead."""
    k, w = 5, 7
    h = NtHasher(k)
    assert backend.sketch(np.zeros(3, np.uint8), k, w, h).size == 0
    got_p, got_i = backend.sketch(np.zeros(3, np.uint8), k, w, h,
                                  mode=pipeline.MODE_SUPERKMERS)
    assert got_p.size == 0 and got_i.size == 0
    for n in (500, pipeline.DEFAULT_C + 40):
        codes = RNG.integers(0, 4, n, dtype=np.uint8)
        np.testing.assert_array_equal(backend.sketch(codes, k, w, h),
                                      _want(codes, k, w, h))


def test_sketch_generic_text_mulhash():
    """General ASCII (&[u8]) + MulHasher: byte values survive the pipeline."""
    text = RNG.integers(32, 127, 8000, dtype=np.uint8)
    k, w = 7, 5
    h = MulHasher(k)
    np.testing.assert_array_equal(backend.sketch(text, k, w, h),
                                  _want(text, k, w, h))


def test_sketch_generic_text_canonical_nt():
    """General text through NtHasher (chars folded to 2 bits) in both
    strands, at a multi-row size."""
    text = np.random.default_rng(0xA5C11).integers(32, 127, 20000,
                                                   dtype=np.uint8)
    k, w = 7, 5
    for h in [MulHasher(k), NtHasher(k, canonical=True)]:
        np.testing.assert_array_equal(backend.sketch(text, k, w, h),
                                      _want(text, k, w, h))


def test_ascii_dna_through_public_api():
    """AsciiSeq input (the reference's ascii-dna input class,
    /root/reference/bench/src/bin/paper.rs:327-340) folds to the same
    2-bit codes as a packed sequence."""
    import simd_minimizers_tpu as sm
    from simd_minimizers_tpu.seq.packed import _CODE_TO_ASCII

    rng = np.random.default_rng(0xA5C12)
    k, w = 21, 11
    codes = rng.integers(0, 4, 30000, dtype=np.uint8)
    got = sm.canonical_minimizers(k, w).run(
        sm.AsciiSeq(_CODE_TO_ASCII[codes])).positions
    np.testing.assert_array_equal(
        got, _want(codes, k, w, NtHasher(k, canonical=True)))


def test_chunked_spans_and_offset():
    """Chunk streaming with global offsets and the dedup seam; run_chunk
    at a non-zero offset shifts every position by it."""
    k, w = 21, 11
    codes = RNG.integers(0, 4, 60000, dtype=np.uint8)
    h = NtHasher(k, canonical=True)
    got = chunked.sketch(codes, k, w, h, chunk_windows=20000)
    np.testing.assert_array_equal(got, _want(codes, k, w, h))
    out, counts, _ = pipeline.run_chunk(codes[:20000], k, w, h, offset=1000,
                                        rows=True)
    np.testing.assert_array_equal(
        pipeline.rows_to_flat(np.asarray(out), np.asarray(counts)),
        _want(codes[:20000], k, w, h) + 1000)


@pytest.mark.parametrize("mode", ["minimizers", "superkmers", "closed_syncmers"])
def test_chunked_spans_all_modes_with_ambiguity(mode):
    """Chunk seams in every mode, with ambiguity clustered at the seams
    (the case where comparing chunk OUTPUTS would misdedup)."""
    k, w = 5, 7
    rng = np.random.default_rng(0x51AA)
    n = 60000
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    amb = np.zeros(n, np.uint8)
    for c in (19990, 20005, 39995, 40012):
        amb[c] = 1
    amb |= (rng.random(n) < 0.001).astype(np.uint8)
    h = NtHasher(k, canonical=True)
    # super-k-mers x skip-ambiguous is undefined in the reference
    # (src/lib.rs:498-503) — chunks are tested without Ns there
    if mode == "superkmers":
        amb = None
    got = chunked.sketch(codes, k, w, h, mode=mode, ambiguous_np=amb,
                         chunk_windows=20000)
    _assert_same(got, _want(codes, k, w, h, mode=mode, ambiguous=amb), mode)


def test_sketch_extreme_k_w_edges():
    """Degenerate geometries: k=1, w=1, k>32 (u128 territory), k=64, all
    hashers — bit-exact vs the oracle."""
    rng = np.random.default_rng(0xED6E)
    for k in (1, 17, 33, 64):
        for w in (1, 2, 17):
            l = k + w - 1
            for hcls in (NtHasher, MulHasher, AntiLexHasher):
                canonical = l % 2 == 1
                n = int(rng.integers(l + 1, 6000))
                codes = rng.integers(0, 4, n, dtype=np.uint8)
                h = hcls(k, canonical=canonical)
                np.testing.assert_array_equal(
                    backend.sketch(codes, k, w, h), _want(codes, k, w, h),
                    err_msg=f"k={k} w={w} {hcls.__name__} canon={canonical}")


@pytest.mark.parametrize("mode", ["minimizers", pipeline.MODE_CLOSED_SYNCMERS])
def test_sketch_skip_ambiguous_clustered(mode):
    """Skip-ambiguous with CLUSTERED Ns (the real-genome shape: most rows
    clean), including an N that lies only in a row's halo, and an
    all-clean mask."""
    rng = np.random.default_rng(0xA3B)
    k, w = 5, 7
    n = 30000
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    amb = np.zeros(n, np.uint8)
    amb[9000:9040] = 1
    amb[pipeline.DEFAULT_C + 2] = 1  # the head of row 1 == row 0's halo
    amb[n - 10] = 1
    h = NtHasher(k, canonical=True)
    for a in (amb, np.zeros(n, np.uint8)):
        got = backend.sketch(codes, k, w, h, mode=mode, ambiguous_np=a)
        _assert_same(got, _want(codes, k, w, h, mode=mode, ambiguous=a))


def test_sketch_large_w():
    """Halos longer than a lane row (l - 1 > C): the reference's w < 2^15
    range (/root/reference/src/sliding_min.rs:93-95)."""
    rng = np.random.default_rng(0xB17)
    for k, w, canonical in [(21, 1100, False), (5, 1501, True)]:
        n = (k + w - 1) + 20000
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        h = NtHasher(k, canonical=canonical)
        np.testing.assert_array_equal(backend.sketch(codes, k, w, h),
                                      _want(codes, k, w, h))


def test_sketch_streams_past_chunk_windows(monkeypatch):
    """Past PIPELINE_CHUNK_WINDOWS windows backend.sketch streams chunks:
    same result as one call."""
    monkeypatch.setattr(backend, "PIPELINE_CHUNK_WINDOWS", 4096)
    k, w = 21, 11
    codes = RNG.integers(0, 4, 20000, dtype=np.uint8)
    h = NtHasher(k, canonical=True)
    calls = []
    orig = chunked.sketch
    monkeypatch.setattr(chunked, "sketch",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    np.testing.assert_array_equal(backend.sketch(codes, k, w, h),
                                  _want(codes, k, w, h))
    assert calls, "did not stream"
