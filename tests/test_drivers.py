"""Differential tests for the three scale drivers.

- ops.chunked.sketch: host loop over fixed chunks (dedup seam state).
- ops.device_driver.DeviceSketcher: whole-sequence single-dispatch loop.
- parallel.shard.sharded_sketch: shard_map over the 8-device CPU mesh
  with the ppermute seam exchange.

All must be bit-identical to the NumPy oracle, including across chunk and
device seams (the reference's cross-lane boundary dedup,
/root/reference/src/collect.rs:252-272).
"""

import numpy as np
import pytest

from simd_minimizers_tpu.hashers import NtHasher
from simd_minimizers_tpu.ops import chunked, oracle, pipeline
from simd_minimizers_tpu.ops.device_driver import DeviceSketcher
from simd_minimizers_tpu.parallel import shard

RNG = np.random.default_rng(0xC0FFEE)


def _want(codes, k, w, h, mode="minimizers", ambiguous=None):
    sel = oracle.selected_stream(codes, k, w, h, ambiguous=ambiguous)
    if mode == pipeline.MODE_SUPERKMERS:
        return oracle.collect_and_dedup_with_index(sel)
    if mode in (pipeline.MODE_CLOSED_SYNCMERS, pipeline.MODE_OPEN_SYNCMERS):
        return oracle.collect_syncmers(sel, w, mode == pipeline.MODE_OPEN_SYNCMERS)
    return oracle.collect_and_dedup(sel, skip_sentinel=ambiguous is not None)


@pytest.mark.parametrize("n", [5000, 16384, 20000])
def test_chunked_matches_oracle(n):
    k, w = 21, 11
    codes = RNG.integers(0, 4, n, dtype=np.uint8)
    h = NtHasher(k, canonical=True)
    got = chunked.sketch(codes, k, w, h, chunk_windows=4096)
    np.testing.assert_array_equal(got, _want(codes, k, w, h))


def test_chunked_superkmers_across_seams():
    k, w = 5, 7
    codes = RNG.integers(0, 4, 10000, dtype=np.uint8)
    h = NtHasher(k)
    got_pos, got_idx = chunked.sketch(
        codes, k, w, h, mode=pipeline.MODE_SUPERKMERS, chunk_windows=2048
    )
    want_pos, want_idx = _want(codes, k, w, h, mode=pipeline.MODE_SUPERKMERS)
    np.testing.assert_array_equal(got_pos, want_pos)
    np.testing.assert_array_equal(got_idx, want_idx)


@pytest.mark.parametrize("mode", [
    pipeline.MODE_MINIMIZERS,
    pipeline.MODE_SUPERKMERS,
    pipeline.MODE_CLOSED_SYNCMERS,
    pipeline.MODE_OPEN_SYNCMERS,
])
def test_device_sketcher_modes(mode):
    k, w = 5, 7
    h = NtHasher(k, canonical=True)
    sk = DeviceSketcher(k, w, h, mode=mode, C=64, R=8, nchunks=4)
    for n in [0, 10, 300, 2048 - 5, 2048]:
        codes = RNG.integers(0, 4, n, dtype=np.uint8)
        got = sk.sketch(codes)
        if n < k + w - 1:
            want = (
                (np.zeros(0, np.uint32),) * 2
                if mode == pipeline.MODE_SUPERKMERS
                else np.zeros(0, np.uint32)
            )
        else:
            want = _want(codes, k, w, h, mode=mode)
        if mode == pipeline.MODE_SUPERKMERS:
            np.testing.assert_array_equal(got[0], want[0], err_msg=f"n={n}")
            np.testing.assert_array_equal(got[1], want[1], err_msg=f"n={n}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"n={n}")


def test_device_sketcher_skip_ambiguous():
    k, w = 5, 7
    h = NtHasher(k, canonical=True)
    sk = DeviceSketcher(k, w, h, C=64, R=8, nchunks=4, skip_ambiguous=True)
    n = 1500
    codes = RNG.integers(0, 4, n, dtype=np.uint8)
    amb = (RNG.random(n) < 0.02).astype(np.uint8)
    got = sk.sketch(codes, amb)
    np.testing.assert_array_equal(got, _want(codes, k, w, h, ambiguous=amb))


@pytest.mark.parametrize("n", [1000, 4096, 5000])
@pytest.mark.parametrize("canonical", [False, True])
def test_sharded_matches_oracle(n, canonical):
    k, w = 21, 11
    codes = RNG.integers(0, 4, n, dtype=np.uint8)
    h = NtHasher(k, canonical=canonical)
    got = shard.sharded_sketch(codes, k, w, h, C=64)
    np.testing.assert_array_equal(got, _want(codes, k, w, h))


def test_sharded_superkmers_and_syncmers():
    k, w = 5, 7
    codes = RNG.integers(0, 4, 3000, dtype=np.uint8)
    h = NtHasher(k)
    got_pos, got_idx = shard.sharded_sketch(
        codes, k, w, h, mode=pipeline.MODE_SUPERKMERS, C=64
    )
    want_pos, want_idx = _want(codes, k, w, h, mode=pipeline.MODE_SUPERKMERS)
    np.testing.assert_array_equal(got_pos, want_pos)
    np.testing.assert_array_equal(got_idx, want_idx)
    got = shard.sharded_sketch(codes, k, w, h, mode=pipeline.MODE_CLOSED_SYNCMERS, C=64)
    np.testing.assert_array_equal(got, _want(codes, k, w, h, mode=pipeline.MODE_CLOSED_SYNCMERS))


def test_device_sketcher_matches_oracle():
    """Pre-compiled short-sequence sketcher (AOT program, donated input)
    == oracle, incl. the pipelined sketch_many path."""
    import numpy as np

    from simd_minimizers_tpu.hashers import NtHasher
    from simd_minimizers_tpu.ops import oracle
    from simd_minimizers_tpu.ops.device_sketcher import ShortSeqSketcher

    rng = np.random.default_rng(0xD5)
    k, w = 21, 11
    h = NtHasher(k, canonical=True)
    sk = ShortSeqSketcher(k, w, h)
    seqs = [rng.integers(0, 4, n, dtype=np.uint8)
            for n in (30, 31, 64, 1024, 8192)]
    wants = [
        (oracle.collect_and_dedup(oracle.selected_stream(s, k, w, h))
         if s.size >= k + w - 1 else np.zeros(0, np.uint32))
        for s in seqs
    ]
    for s, want in zip(seqs, wants):
        np.testing.assert_array_equal(sk.sketch(s), want)
    for got, want in zip(sk.sketch_many(seqs), wants):
        np.testing.assert_array_equal(got, want)


def test_device_sketcher_superkmers():
    import numpy as np

    from simd_minimizers_tpu.hashers import NtHasher
    from simd_minimizers_tpu.ops import oracle
    from simd_minimizers_tpu.ops.device_sketcher import ShortSeqSketcher

    rng = np.random.default_rng(0xD6)
    k, w = 5, 7
    h = NtHasher(k, canonical=True)
    sk = ShortSeqSketcher(k, w, h, mode="superkmers")
    codes = rng.integers(0, 4, 2000, dtype=np.uint8)
    got_p, got_i = sk.sketch(codes)
    want_p, want_i = oracle.collect_and_dedup_with_index(
        oracle.selected_stream(codes, k, w, h))
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_i, want_i)


def test_short_seq_sketcher_launch_harvest_offset():
    """Async launch/harvest with a global offset; inputs past max_chars
    are refused; measure_floor reports its three floors."""
    from simd_minimizers_tpu.ops.device_sketcher import ShortSeqSketcher

    rng = np.random.default_rng(0xD7)
    k, w = 21, 11
    h = NtHasher(k, canonical=True)
    sk = ShortSeqSketcher(k, w, h, C=256)
    assert sk.max_chars == 8 * 256 + k + w - 2
    codes = rng.integers(0, 4, sk.max_chars, dtype=np.uint8)
    handles = [sk.launch(codes, offset=off) for off in (0, 7, 1 << 31)]
    want = _want(codes, k, w, h)
    for off, hd in zip((0, 7, 1 << 31), handles):
        np.testing.assert_array_equal(sk.harvest(hd), want + np.uint32(off))
    with pytest.raises(AssertionError, match="route longer inputs"):
        sk.launch(np.zeros(sk.max_chars + 1, np.uint8))
    floor = sk.measure_floor(codes, m=3, probes=1)
    assert set(floor) == {"sync_us", "per_call_us", "device_floor_us"}


@pytest.mark.parametrize("mode", ["closed_syncmers", "open_syncmers"])
def test_short_seq_sketcher_syncmers(mode):
    from simd_minimizers_tpu.ops.device_sketcher import ShortSeqSketcher

    rng = np.random.default_rng(0xD8)
    k, w = 11, 7
    h = NtHasher(k)
    sk = ShortSeqSketcher(k, w, h, mode=mode, C=256)
    for n in (10, 17, 300, sk.max_chars):
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        want = (_want(codes, k, w, h, mode=mode) if n >= k + w - 1
                else np.zeros(0, np.uint32))
        np.testing.assert_array_equal(sk.sketch(codes), want, err_msg=f"n={n}")


@pytest.mark.parametrize("mode", ["minimizers", "superkmers",
                                  "closed_syncmers", "open_syncmers"])
def test_sketch_records_pipeline(mode, monkeypatch):
    """backend.sketch_records: per-record results bit-identical to
    sketching each record alone — mixed lengths incl. empty, sub-window,
    single-chunk, and multi-chunk records (a small PIPELINE_CHUNK_WINDOWS
    makes the big one stream)."""
    from simd_minimizers_tpu.ops import backend

    monkeypatch.setattr(backend, "PIPELINE_CHUNK_WINDOWS", 12000)

    k, w = 7, 5
    l = k + w - 1
    h = NtHasher(k, canonical=True)
    rng = np.random.default_rng(0x5EC5)
    recs = [
        np.zeros(0, np.uint8),                              # empty
        rng.integers(0, 4, l - 1, dtype=np.uint8),          # sub-window
        rng.integers(0, 4, 900, dtype=np.uint8),            # single span
        rng.integers(0, 4, 33000, dtype=np.uint8),          # multi span
        rng.integers(0, 4, 2500, dtype=np.uint8),
    ]
    got = backend.sketch_records(recs, k, w, h, mode=mode)
    assert len(got) == len(recs)
    for codes, g in zip(recs, got):
        want = _want(codes, k, w, h, mode=mode) if codes.size >= l else (
            (np.zeros(0, np.uint32), np.zeros(0, np.uint32))
            if mode == pipeline.MODE_SUPERKMERS else np.zeros(0, np.uint32))
        if mode == pipeline.MODE_SUPERKMERS:
            np.testing.assert_array_equal(g[0], want[0])
            np.testing.assert_array_equal(g[1], want[1])
        else:
            np.testing.assert_array_equal(g, want)


def test_sketch_records_skip_ambiguous_and_asserts():
    """Per-record ambiguity masks flow through sketch_records (None
    entries allowed); superkmers x ambiguity is rejected like the public
    API."""
    from simd_minimizers_tpu.ops import backend

    k, w = 5, 7
    l = k + w - 1
    h = NtHasher(k, canonical=True)
    rng = np.random.default_rng(0xA11B)
    recs = [rng.integers(0, 4, n, dtype=np.uint8) for n in (400, 15000, 64)]
    ambs = [None,
            (rng.random(15000) < 0.01).astype(np.uint8),
            (rng.random(64) < 0.2).astype(np.uint8)]
    got = backend.sketch_records(recs, k, w, h, ambiguous=ambs)
    for codes, amb, g in zip(recs, ambs, got):
        np.testing.assert_array_equal(g, _want(codes, k, w, h, ambiguous=amb))
    with pytest.raises(AssertionError):
        backend.sketch_records(recs, k, w, h, mode="superkmers",
                               ambiguous=ambs)
    with pytest.raises(AssertionError, match="align"):
        backend.sketch_records(recs, k, w, h, ambiguous=ambs[:2])


@pytest.mark.parametrize("mode", ["minimizers", "superkmers",
                                  "closed_syncmers", "open_syncmers"])
def test_backend_records_batch_routing(mode, monkeypatch):
    """backend.sketch_records routes many small records through the batch
    engine (one launch per stride bucket) while big records are sketched
    on their own; the reassembled per-record results must be bit-identical
    to sketching each record alone (incl. empty / sub-window records)."""
    from simd_minimizers_tpu.ops import backend

    k, w = 7, 5
    l = k + w - 1
    h = NtHasher(k, canonical=True)
    rng = np.random.default_rng(0xBA7C)
    recs = ([rng.integers(0, 4, int(n), dtype=np.uint8)
             for n in rng.integers(l, 300, 12)]            # 12 small
            + [np.zeros(0, np.uint8),                      # empty
               rng.integers(0, 4, l - 1, dtype=np.uint8),  # sub-window
               rng.integers(0, 4, 5000, dtype=np.uint8)])  # big (> max bp)
    order = rng.permutation(len(recs))
    recs = [recs[i] for i in order]

    monkeypatch.setattr(backend, "RECORDS_BATCH_MAX_BP", 1000)
    batched = _count_batches(monkeypatch, backend)
    got = backend.sketch_records(recs, k, w, h, mode=mode)
    assert batched == [12], "the 12 small records share one batch call"
    assert len(got) == len(recs)
    empty = np.zeros(0, np.uint32)
    for codes, g in zip(recs, got):
        want = _want(codes, k, w, h, mode=mode) if codes.size >= l else (
            (empty, empty) if mode == pipeline.MODE_SUPERKMERS else empty)
        if mode == pipeline.MODE_SUPERKMERS:
            np.testing.assert_array_equal(g[0], want[0])
            np.testing.assert_array_equal(g[1], want[1])
        else:
            np.testing.assert_array_equal(g, want)


def test_backend_records_batch_routing_ambiguous(monkeypatch):
    """Batch-routed small records honor per-record ambiguity masks, with
    None entries normalized for the batch engine."""
    from simd_minimizers_tpu.ops import backend

    k, w = 5, 7
    h = NtHasher(k, canonical=True)
    rng = np.random.default_rng(0xA3B1)
    recs = [rng.integers(0, 4, int(n), dtype=np.uint8)
            for n in rng.integers(40, 300, 10)] + [
            rng.integers(0, 4, 4000, dtype=np.uint8)]
    ambs = [(rng.random(r.size) < 0.05).astype(np.uint8) if i % 2 else None
            for i, r in enumerate(recs)]

    monkeypatch.setattr(backend, "RECORDS_BATCH_MAX_BP", 1000)
    batched = _count_batches(monkeypatch, backend)
    got = backend.sketch_records(recs, k, w, h, ambiguous=ambs)
    assert batched == [10]
    for codes, amb, g in zip(recs, ambs, got):
        np.testing.assert_array_equal(g, _want(codes, k, w, h, ambiguous=amb))


def test_large_w_span_batch_records_interplay(monkeypatch):
    """Large w (l - 1 longer than a lane row) through every driver that
    slices or pads around l: chunk streaming's overlapping chunks (overlap
    l - 1 = 1220), the batch engine's stride bucketing (reads barely
    >= l), and sketch_records' mixed lengths — all vs the oracle."""
    from simd_minimizers_tpu.ops import backend
    from simd_minimizers_tpu.ops.batch import sketch_batch

    rng = np.random.default_rng(0x1A46)
    k, w = 21, 1200
    l = k + w - 1

    def want(codes):
        return oracle.collect_and_dedup(
            oracle.selected_stream(codes, k, w, NtHasher(k)))

    codes = rng.integers(0, 4, 3 * 20000, dtype=np.uint8)
    got = chunked.sketch(codes, k, w, NtHasher(k), chunk_windows=20000)
    np.testing.assert_array_equal(got, want(codes))

    reads = [rng.integers(0, 4, int(m), dtype=np.uint8)
             for m in (l, l + 1, 3 * l, l - 1, 5000)]
    rid, pos = sketch_batch(reads, k, w, NtHasher(k))
    for i, rd in enumerate(reads):
        w_i = want(rd) if len(rd) >= l else np.zeros(0, np.uint32)
        np.testing.assert_array_equal(pos[rid == i], w_i, err_msg=f"read {i}")

    monkeypatch.setattr(backend, "PIPELINE_CHUNK_WINDOWS", 21000)
    recs = [rng.integers(0, 4, m, dtype=np.uint8) for m in (25000, l, 40000)]
    outs = backend.sketch_records(recs, k, w, NtHasher(k))
    for rec, o in zip(recs, outs):
        np.testing.assert_array_equal(o, want(rec))


def _count_batches(monkeypatch, backend):
    """Record the record count of every backend.sketch_batch call."""
    calls = []
    orig = backend.sketch_batch

    def counting(records, *a, **kw):
        calls.append(len(records))
        return orig(records, *a, **kw)

    monkeypatch.setattr(backend, "sketch_batch", counting)
    return calls
