"""API-shape tests mirroring the reference builder test
(/root/reference/src/test.rs:279-332) plus value extraction checks."""

import numpy as np
import pytest

import simd_minimizers_tpu as sm
from simd_minimizers_tpu.seq.packed import PackedNSeqVec, PackedSeqVec

RNG = np.random.default_rng(77)


def test_builder_shapes():
    seq = PackedSeqVec.random(512, RNG)
    k, w = 5, 7
    hasher = sm.MulHasher(k, canonical=True, seed=1234)

    sm.minimizers(k, w).run(seq)
    sm.canonical_minimizers(k, w).run(seq)
    out = sm.minimizers(k, w).super_kmers().run(seq)
    assert out.superkmer_indices is not None
    sm.canonical_minimizers(k, w).hasher(hasher).run(seq)
    out = sm.canonical_minimizers(k, w).hasher(hasher).super_kmers().run(seq)
    assert out.values_u64().dtype == np.uint64
    assert all(isinstance(v, int) for v in out.values_u128())
    # reuse of a configured builder
    m = sm.canonical_minimizers(k, w).hasher(hasher)
    for _ in range(3):
        m.super_kmers().run(seq)
    # syncmers
    sm.closed_syncmers(k, w).run(seq)
    sm.closed_syncmers(k, w).run_once(seq)
    sm.closed_syncmers(k, w).run_scalar_once(seq)
    sm.canonical_closed_syncmers(k, w).run(seq).pos_and_values_u64()
    sm.open_syncmers(k, w).run(seq)
    sm.canonical_open_syncmers(k, w).run(seq).pos_and_values_u64()


def test_run_equals_run_scalar():
    seq = PackedSeqVec.random(777, RNG)
    for b in [
        sm.minimizers(5, 7),
        sm.canonical_minimizers(21, 11),
        sm.closed_syncmers(5, 7),
        sm.canonical_open_syncmers(5, 7),
        sm.minimizers(5, 7).super_kmers(),
    ]:
        fast, slow = b.run(seq), b.run_scalar(seq)
        np.testing.assert_array_equal(fast.positions, slow.positions)
        if fast.superkmer_indices is not None:
            np.testing.assert_array_equal(fast.superkmer_indices, slow.superkmer_indices)


def test_superkmer_values_match_positions():
    seq = PackedSeqVec.random(512, RNG)
    out = sm.canonical_minimizers(5, 7).super_kmers().run(seq)
    vals = out.values_u64()
    for p, v in zip(out.positions.tolist(), vals.tolist()):
        assert v == min(seq.read_kmer(5, p), seq.read_revcomp_kmer(5, p))


def test_syncmer_values_are_lmers():
    seq = PackedSeqVec.random(300, RNG)
    k, w = 5, 7
    out = sm.closed_syncmers(k, w).run(seq)
    assert out.length == k + w - 1
    vals = out.values_u64()
    for p, v in zip(out.positions.tolist(), vals.tolist()):
        assert v == seq.read_kmer(k + w - 1, p)


def test_skip_ambiguous_api():
    n = 400
    arr = np.frombuffer(sm.AsciiSeq.random(n, RNG).seq.tobytes(), dtype=np.uint8).copy()
    arr[RNG.integers(0, n, 5)] = ord("N")
    nseq = PackedNSeqVec.from_ascii(arr)
    pos = sm.canonical_minimizers(5, 7).run_skip_ambiguous_windows_once(nseq)
    for p in pos.tolist():
        assert not nseq.ambiguous[p : p + 5].any()


def test_values_u128_large_k():
    seq = PackedSeqVec.random(600, RNG)
    k, w = 48, 5
    out = sm.minimizers(k, w).run(seq)
    with pytest.raises(AssertionError):
        out.values_u64()
    vals = out.values_u128()
    for p, v in zip(out.positions.tolist(), vals):
        assert v == seq.read_kmer(k, p)


def test_baseline_config_superkmers_mulhasher_values():
    """BASELINE config 3: minimizers + super_kmers + values_u64, MulHasher."""
    from simd_minimizers_tpu.hashers import MulHasher
    from simd_minimizers_tpu.seq.packed import PackedSeqVec

    rng = np.random.default_rng(33)
    seq = PackedSeqVec.random(3000, rng)
    k, w = 11, 7
    out = sm.minimizers(k, w).hasher(MulHasher(k)).super_kmers().run(seq)
    ref = sm.minimizers(k, w).hasher(MulHasher(k)).super_kmers().run_scalar(seq)
    np.testing.assert_array_equal(out.positions, ref.positions)
    np.testing.assert_array_equal(out.superkmer_indices, ref.superkmer_indices)
    vals = out.values_u64()
    assert vals.size == out.positions.size
    # values are the packed k-mers at the reported positions
    codes = seq.codes()
    for p, v in list(zip(out.positions[:20], vals[:20])):
        want = 0
        for i, c in enumerate(codes[p : p + k]):
            want |= int(c) << (2 * i)
        assert int(v) == want


def test_generic_text_public_api():
    """Plain non-ACGT bytes are general ASCII text (`&[u8]`,
    /root/reference/src/lib.rs:57-72): positions match the oracle run on
    the raw byte values, values pack 8 bits per char."""
    from simd_minimizers_tpu.hashers import MulHasher, NtHasher
    from simd_minimizers_tpu.ops import oracle
    from simd_minimizers_tpu.seq.packed import GenericSeq, as_seq

    text = bytes(RNG.integers(32, 127, 400, dtype=np.uint8))
    raw = np.frombuffer(text, np.uint8)
    assert isinstance(as_seq(text), GenericSeq)
    k, w = 7, 5
    for h in [MulHasher(k), NtHasher(k)]:
        got = sm.minimizers(k, w).hasher(h).run_once(text)
        want = oracle.collect_and_dedup(oracle.selected_stream(raw, k, w, h))
        np.testing.assert_array_equal(got, want)
    # canonical (l odd) with values
    k, w = 6, 6
    h = MulHasher(k, canonical=True)
    out = sm.canonical_minimizers(k, w).hasher(h).run(text)
    want = oracle.collect_and_dedup(
        oracle.selected_stream(raw, k, w, h))
    np.testing.assert_array_equal(out.positions, want)
    vals = out.values_u64()
    gs = GenericSeq(raw)
    for p, v in zip(out.positions.tolist(), vals.tolist()):
        assert v == min(gs.read_kmer(k, p), gs.read_revcomp_kmer(k, p))
    # ACGT-only bytes keep DNA semantics (golden vectors rely on this)
    assert not isinstance(as_seq(b"ACGTacgt"), GenericSeq)


def test_generic_text_values_u128():
    from simd_minimizers_tpu.hashers import MulHasher
    from simd_minimizers_tpu.seq.packed import GenericSeq

    text = bytes(RNG.integers(32, 127, 300, dtype=np.uint8))
    k, w = 12, 4  # 12 chars * 8 bits = 96 > 64: needs the u128 path
    h = MulHasher(k)
    out = sm.minimizers(k, w).hasher(h).run(text)
    with pytest.raises(AssertionError):
        out.values_u64()
    vals = out.values_u128()
    gs = GenericSeq(np.frombuffer(text, np.uint8))
    for p, v in zip(out.positions.tolist(), vals):
        assert v == gs.read_kmer(k, p)


def test_values_u128_limbs_match_ints():
    seq = PackedSeqVec.random(500, RNG)
    k, w = 48, 6  # l = 53, odd
    out = sm.canonical_minimizers(k, w).run(seq)
    lo, hi = out.values_u128_limbs()
    ints = out.values_u128()
    assert lo.dtype == hi.dtype == np.uint64
    for a, b, v in zip(lo.tolist(), hi.tolist(), ints):
        assert ((b << 64) | a) == v


def test_backend_routes_huge_inputs_through_chunked(monkeypatch):
    """Dispatch streams big inputs in fixed-geometry chunks."""
    from simd_minimizers_tpu.ops import backend, chunked, oracle

    monkeypatch.setattr(backend, "PIPELINE_CHUNK_WINDOWS", 1 << 12)
    calls = []
    orig = chunked.sketch

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(chunked, "sketch", spy)
    codes = RNG.integers(0, 4, 3 * (1 << 12) + 100, dtype=np.uint8)
    h = sm.NtHasher(21, canonical=True)
    got = backend.sketch(codes, 21, 11, h)
    assert calls, "chunked path not taken"
    want = oracle.collect_and_dedup(oracle.selected_stream(codes, 21, 11, h))
    np.testing.assert_array_equal(got, want)


def test_values_chunked_blocks_match_unchunked(monkeypatch):
    """Value extraction processes positions in memory-bounded blocks at
    genome scale; block boundaries must not change any result."""
    from simd_minimizers_tpu.ops import values as V

    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, 1200, dtype=np.uint8)
    pos = np.sort(rng.choice(1100, 150, replace=False)).astype(np.uint32)
    want64 = V.kmer_values_u64(codes, pos, 31)
    wantc = V.canonical_kmer_values_u64(codes, pos, 31)
    want128 = V.canonical_kmer_values_u128_limbs(codes, pos, 49)
    monkeypatch.setattr(V, "VALUE_CHUNK", 11)
    np.testing.assert_array_equal(V.kmer_values_u64(codes, pos, 31), want64)
    np.testing.assert_array_equal(V.canonical_kmer_values_u64(codes, pos, 31), wantc)
    got = V.canonical_kmer_values_u128_limbs(codes, pos, 49)
    np.testing.assert_array_equal(got[0], want128[0])
    np.testing.assert_array_equal(got[1], want128[1])


def test_superkmers_rejects_ambiguity_mask():
    """The reference makes super-kmers + skip-ambiguous unrepresentable
    (/root/reference/src/lib.rs:498-503); run() must assert, not silently
    drop the mask."""
    codes = RNG.integers(0, 4, 200, dtype=np.uint8)
    amb = np.zeros(200, np.uint8)
    amb[50] = 1
    b = sm.canonical_minimizers(5, 7).super_kmers()
    with pytest.raises(AssertionError, match="super_kmers"):
        b.run(codes, ambiguous=amb)


def test_public_api_never_probes_input_on_host():
    """The DNA/text decision comes from the seq type: DNA, text and
    batched reads run through one pipeline, with no O(n) host probe of
    the codes anywhere in the package."""
    from simd_minimizers_tpu.utils import bits

    assert not hasattr(bits, "probe_is_dna")
    codes = RNG.integers(0, 4, 3000, dtype=np.uint8)
    h = sm.NtHasher(11, canonical=True)
    out = sm.canonical_minimizers(11, 7).hasher(h).run(
        sm.PackedSeqVec.from_codes(codes))
    assert out.positions.size > 0
    # general text flows through the same probe-free path
    text = bytes((RNG.integers(32, 127, 2000)).astype(np.uint8))
    out2 = sm.minimizers(7, 5).hasher(sm.MulHasher(7)).run(text)
    assert out2.positions.size > 0
    # batched reads too
    rid, pos = sm.minimizers(5, 7).run_batch(
        [sm.PackedSeqVec.from_codes(RNG.integers(0, 4, 64, dtype=np.uint8))
         for _ in range(3)])
    assert rid.size > 0


def test_run_batch_rejects_superkmers_ambiguity():
    """run_batch must enforce the same unrepresentable combination as
    run() (/root/reference/src/lib.rs:498-503)."""
    codes = RNG.integers(0, 4, 200, dtype=np.uint8)
    amb = np.zeros(200, np.uint8)
    b = sm.canonical_minimizers(5, 7).super_kmers()
    with pytest.raises(AssertionError, match="super_kmers"):
        b.run_batch([codes], ambiguous=[amb])
