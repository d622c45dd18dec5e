"""Native packer + FASTA scanner vs NumPy reference."""

import gzip

import numpy as np

from simd_minimizers_tpu import native
from simd_minimizers_tpu.seq.fasta import read_fasta
from simd_minimizers_tpu.seq.packed import PackedSeqVec

RNG = np.random.default_rng(11)


def test_native_available():
    assert native.available(), "g++ toolchain expected in this image"


def test_pack_ascii_matches_numpy():
    ascii_arr = RNG.integers(32, 127, 10000, dtype=np.uint8)
    codes, amb = native.pack_ascii(ascii_arr)
    np.testing.assert_array_equal(codes, (ascii_arr >> 1) & 3)
    is_acgt = np.isin(ascii_arr, np.frombuffer(b"ACGTacgt", np.uint8))
    np.testing.assert_array_equal(amb.astype(bool), ~is_acgt)


def test_pack_2bit_matches_packedseq():
    codes = RNG.integers(0, 4, 10001, dtype=np.uint8)
    np.testing.assert_array_equal(
        native.pack_2bit(codes), PackedSeqVec.from_codes(codes).data
    )


def test_fasta_scan_and_read(tmp_path):
    fa = (
        b">chr1 some description\r\n"
        b"ACGTacgtNNRY\r\n"
        b"GGGG\n"
        b">chr2\n"
        b"TTTT\nACGT\n"
    )
    p = tmp_path / "toy.fa"
    p.write_bytes(fa)
    recs = read_fasta(str(p))
    assert [r.name for r in recs] == ["chr1", "chr2"]
    assert len(recs[0]) == 16 and len(recs[1]) == 8
    # lowercase folds to same codes; N/R/Y flagged ambiguous
    exp0 = ((np.frombuffer(b"ACGTacgtNNRYGGGG", np.uint8) >> 1) & 3).astype(np.uint8)
    np.testing.assert_array_equal(recs[0].codes, exp0)
    np.testing.assert_array_equal(
        recs[0].ambiguous.astype(bool),
        np.array([0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0], bool),
    )
    # gzip round-trip
    pg = tmp_path / "toy.fa.gz"
    pg.write_bytes(gzip.compress(fa))
    recs2 = read_fasta(str(pg))
    assert len(recs2) == 2
    np.testing.assert_array_equal(recs2[1].codes, recs[1].codes)


def test_synth_fasta_width_multiple(tmp_path):
    """Records whose length is an exact multiple of the line width must
    keep their trailing newline so the next '>' starts a line (round-4
    fasta_e2e bug: 24 x 45 Mbp parsed as ONE record with headers folded
    into the sequence)."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "bench"))
    from exp_fasta import synth_fasta

    for n_bp in (120, 1000):  # exact multiple of width=60, and ragged
        path = str(tmp_path / f"s{n_bp}.fa")
        synth_fasta(path, 3, n_bp / 1e6)
        recs = read_fasta(path)
        assert len(recs) == 3, (n_bp, len(recs))
        assert all(len(r) == n_bp for r in recs)
        assert [r.name for r in recs] == ["synth0", "synth1", "synth2"]


def test_fasta_edge_cases(tmp_path):
    """Empty file, header-only record, missing trailing newline, blank
    line inside a record — the C++ scanner and the CLI path must parse
    all of them (behavior pinned round 4)."""
    cases = [
        (b"", []),
        (b">only header\n", [("only", 0)]),
        (b">a\nACGT", [("a", 4)]),
        (b">a\n\n>b\nAC\n", [("a", 0), ("b", 2)]),
        (b"ACGT\nAC\n", [("seq0", 6)]),  # headerless implicit record
    ]
    for i, (content, want) in enumerate(cases):
        p = tmp_path / f"e{i}.fa"
        p.write_bytes(content)
        recs = read_fasta(str(p))
        assert [(r.name, len(r)) for r in recs] == want, (content, recs)
