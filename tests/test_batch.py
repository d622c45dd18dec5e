"""Batched-reads sketching (flat slot packing, one pipeline launch per
stride bucket) == per-read oracle."""

import numpy as np
import pytest

from simd_minimizers_tpu.hashers import NtHasher
from simd_minimizers_tpu.ops import oracle, pipeline
from simd_minimizers_tpu.ops.batch import _stride_bucket, sketch_batch

RNG = np.random.default_rng(0xBA7C4)


def _reads(lens):
    return [RNG.integers(0, 4, n, dtype=np.uint8) for n in lens]


def test_stride_bucket():
    for x in range(1, 4000):
        s = _stride_bucket(x)
        assert s >= x
        assert s < max(x * 1.125 + 1, 9), (x, s)  # 3-bit mantissa: <12.5% waste
    assert _stride_bucket(151) == 160
    assert _stride_bucket(251) == 256
    assert _stride_bucket(1025) == 1152


@pytest.mark.parametrize("canonical", [False, True])
def test_batch_minimizers(canonical):
    k, w = 21, 11
    reads = _reads([500, 31, 30, 0, 1024, 77, 300, 1024, 999, 64, 150])
    h = NtHasher(k, canonical=canonical)
    rid, pos = sketch_batch(reads, k, w, h)
    assert np.all(np.diff(rid) >= 0)  # ordered by read
    for i, rd in enumerate(reads):
        want = (
            oracle.collect_and_dedup(oracle.selected_stream(rd, k, w, h))
            if len(rd) >= k + w - 1 else np.zeros(0, np.uint32)
        )
        np.testing.assert_array_equal(pos[rid == i], want, err_msg=f"read {i}")


def test_batch_superkmers():
    k, w = 5, 7
    reads = _reads([200, 64, 1000])
    h = NtHasher(k, canonical=True)
    rid, pos, widx = sketch_batch(reads, k, w, h, mode=pipeline.MODE_SUPERKMERS)
    for i, rd in enumerate(reads):
        want_pos, want_idx = oracle.collect_and_dedup_with_index(
            oracle.selected_stream(rd, k, w, h))
        np.testing.assert_array_equal(pos[rid == i], want_pos, err_msg=f"read {i}")
        np.testing.assert_array_equal(widx[rid == i], want_idx, err_msg=f"read {i}")


@pytest.mark.parametrize("mode", [pipeline.MODE_CLOSED_SYNCMERS, pipeline.MODE_OPEN_SYNCMERS])
def test_batch_syncmers(mode):
    k, w = 11, 7
    reads = _reads([300, 500])
    h = NtHasher(k)
    rid, pos = sketch_batch(reads, k, w, h, mode=mode)
    for i, rd in enumerate(reads):
        want = oracle.collect_syncmers(
            oracle.selected_stream(rd, k, w, h), w,
            mode == pipeline.MODE_OPEN_SYNCMERS)
        np.testing.assert_array_equal(pos[rid == i], want, err_msg=f"read {i}")


def test_batch_skip_ambiguous():
    k, w = 5, 7
    lens = [400, 700]
    reads = _reads(lens)
    amb = [(RNG.random(n) < 0.02).astype(np.uint8) for n in lens]
    h = NtHasher(k, canonical=True)
    rid, pos = sketch_batch(reads, k, w, h, ambiguous=amb)
    for i, rd in enumerate(reads):
        sel = oracle.selected_stream(rd, k, w, h, ambiguous=amb[i])
        want = oracle.collect_and_dedup(sel, skip_sentinel=True)
        np.testing.assert_array_equal(pos[rid == i], want, err_msg=f"read {i}")


def test_batch_split_over_launch_cap(monkeypatch):
    """Batches above the per-launch char cap split and merge seamlessly."""
    import simd_minimizers_tpu.ops.batch as B

    monkeypatch.setattr(B, "MAX_LAUNCH_CHARS", 4 * 72)  # 4 slots of stride 72
    k, w = 5, 7
    reads = RNG.integers(0, 4, (11, 64), dtype=np.uint8)
    h = NtHasher(k, canonical=True)
    rid, pos = sketch_batch(reads, k, w, h)
    for i in range(11):
        want = oracle.collect_and_dedup(oracle.selected_stream(reads[i], k, w, h))
        np.testing.assert_array_equal(pos[rid == i], want, err_msg=f"read {i}")


@pytest.mark.parametrize("canonical", [False, True])
def test_batch_dense_short_reads(canonical):
    """Mixed lengths spread over several stride buckets, one long 10kb read
    (longer than a lane row: spans multiple rows)."""
    k, w = 21, 11
    lens = [150, 0, 200, 31, 100, 250, 37, 250, 199, 64, 250, 180, 90, 10_000]
    reads = _reads(lens)
    h = NtHasher(k, canonical=canonical)
    rid, pos = sketch_batch(reads, k, w, h)
    for i, rd in enumerate(reads):
        want = (
            oracle.collect_and_dedup(oracle.selected_stream(rd, k, w, h))
            if len(rd) >= k + w - 1 else np.zeros(0, np.uint32)
        )
        np.testing.assert_array_equal(pos[rid == i], want, err_msg=f"read {i}")


def test_batch_dense_superkmers_and_ambiguous():
    k, w = 5, 7
    lens = [100, 120, 50, 128, 90]
    reads = _reads(lens)
    h = NtHasher(k, canonical=True)
    rid, pos, widx = sketch_batch(reads, k, w, h, mode=pipeline.MODE_SUPERKMERS)
    for i, rd in enumerate(reads):
        want_pos, want_idx = oracle.collect_and_dedup_with_index(
            oracle.selected_stream(rd, k, w, h))
        np.testing.assert_array_equal(pos[rid == i], want_pos, err_msg=f"read {i}")
        np.testing.assert_array_equal(widx[rid == i], want_idx, err_msg=f"read {i}")
    amb = [(RNG.random(n) < 0.05).astype(np.uint8) for n in lens]
    rid, pos = sketch_batch(reads, k, w, h, ambiguous=amb)
    for i, rd in enumerate(reads):
        sel = oracle.selected_stream(rd, k, w, h, ambiguous=amb[i])
        want = oracle.collect_and_dedup(sel, skip_sentinel=True)
        np.testing.assert_array_equal(pos[rid == i], want, err_msg=f"read {i}")


def test_batch_pipeline_backend():
    """The batch path reached through backend.sketch_batch matches the
    oracle."""
    from simd_minimizers_tpu.ops import backend

    k, w = 21, 11
    reads = _reads([500, 150, 0, 999, 150, 150])
    h = NtHasher(k, canonical=True)
    rid, pos = backend.sketch_batch(reads, k, w, h)
    for i, rd in enumerate(reads):
        want = (
            oracle.collect_and_dedup(oracle.selected_stream(rd, k, w, h))
            if len(rd) >= k + w - 1 else np.zeros(0, np.uint32)
        )
        np.testing.assert_array_equal(pos[rid == i], want, err_msg=f"read {i}")


def test_batch_generic_text_via_backend():
    """General ASCII reads route through the flat pipeline batch path."""
    from simd_minimizers_tpu.hashers import MulHasher
    from simd_minimizers_tpu.ops import backend

    k, w = 7, 5
    texts = [RNG.integers(32, 127, n, dtype=np.uint8) for n in [100, 300, 50]]
    h = MulHasher(k)
    rid, pos = backend.sketch_batch(texts, k, w, h)
    for i, t in enumerate(texts):
        want = oracle.collect_and_dedup(oracle.selected_stream(t, k, w, h))
        np.testing.assert_array_equal(pos[rid == i], want, err_msg=f"text {i}")
