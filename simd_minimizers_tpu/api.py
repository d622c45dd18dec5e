"""Public builder API, mirroring the reference crate's DSL.

Reference shape (/root/reference/src/lib.rs:221-448):

    minimizers(k, w).hasher(h).super_kmers(sk).run(seq, out).values_u64()

Python shape:

    out = minimizers(k, w).hasher(h).super_kmers().run(seq)
    out.positions, out.superkmer_indices, out.values_u64()

`run` uses the accelerated JAX backend; `run_scalar` uses the NumPy oracle
(the reference's scalar fallback, /root/reference/src/lib.rs:370-376).
Both produce bit-identical results — this is enforced by the test suite.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .hashers import KmerHasher, NtHasher
from .ops import oracle, values
from .seq.packed import PackedNSeqVec, as_seq

_SYNCMER_NONE, _SYNCMER_CLOSED, _SYNCMER_OPEN = 0, 1, 2


@dataclasses.dataclass
class Output:
    """Result of a builder run (the `Output` equivalent).

    `length` is k for minimizers and k+w-1 for syncmers
    (/root/reference/src/lib.rs:439-447).
    """

    length: int
    seq: object
    positions: np.ndarray
    superkmer_indices: np.ndarray | None = None
    canonical: bool = False

    def _codes(self) -> np.ndarray:
        return self.seq.codes()

    @property
    def _bits(self) -> int:
        # 2 bits/char for DNA, 8 for general ASCII text (GenericSeq)
        return getattr(self.seq, "char_bits", 2)

    # above this many positions, 2-bit values are assembled on the GPU
    # (ops/device_values.py) instead of by the host gather — bit-identical.
    # The threshold is not measured on the H100; SMTPU_DEVICE_VALUES_MIN
    # overrides it.
    DEVICE_VALUES_MIN = int(os.environ.get("SMTPU_DEVICE_VALUES_MIN",
                                           1 << 22))

    def _use_device_values(self, max_length: int) -> bool:
        if (self._bits != 2 or self.length > max_length
                or self.positions.size < Output.DEVICE_VALUES_MIN):
            return False
        # never initialize a JAX backend from a pure-NumPy call path (a
        # scalar-oracle Output must not claim the device just to extract
        # values)
        import sys

        if "jax" not in sys.modules:
            return False
        import jax

        return jax.default_backend() == "gpu"

    def _device_words(self):
        """u32 word stream for device values — zero-copy off PackedSeq's
        byte-aligned packed buffer, else one native repack of the codes."""
        from .ops import device_values
        from .seq.packed import PackedSeq

        if isinstance(self.seq, PackedSeq) and self.seq.offset % 4 == 0:
            return device_values.words_from_packed_bytes(
                self.seq.packed_with_offset()[0])
        return device_values.pack_words_np(self._codes())

    def values_u64(self) -> np.ndarray:
        if self._use_device_values(32):
            from .ops import device_values

            return device_values.kmer_values_u64(
                self._device_words(), self.positions, self.length,
                canonical=self.canonical)
        if self.canonical:
            return values.canonical_kmer_values_u64(
                self._codes(), self.positions, self.length, self._bits)
        return values.kmer_values_u64(self._codes(), self.positions, self.length, self._bits)

    def values_u128(self) -> list[int]:
        if self.canonical:
            return values.canonical_kmer_values_u128(
                self._codes(), self.positions, self.length, self._bits)
        return values.kmer_values_u128(self._codes(), self.positions, self.length, self._bits)

    def values_u128_limbs(self) -> tuple[np.ndarray, np.ndarray]:
        """(lo, hi) u64 limb arrays — vectorized u128s for sketch-scale use."""
        if self._use_device_values(64):
            from .ops import device_values

            return device_values.kmer_values_u128_limbs(
                self._device_words(), self.positions, self.length,
                canonical=self.canonical)
        if self.canonical:
            return values.canonical_kmer_values_u128_limbs(
                self._codes(), self.positions, self.length, self._bits)
        return values.kmer_values_u128_limbs(
            self._codes(), self.positions, self.length, self._bits)

    def pos_and_values_u64(self) -> tuple[np.ndarray, np.ndarray]:
        return self.positions, self.values_u64()

    def pos_and_values_u128(self) -> tuple[np.ndarray, list[int]]:
        return self.positions, self.values_u128()


@dataclasses.dataclass
class Builder:
    """Type-state builder (the reference's const generics become fields)."""

    k: int
    w: int
    canonical: bool
    syncmer: int = _SYNCMER_NONE
    _hasher: KmerHasher | None = None
    _super_kmers: bool = False

    # -- configuration ------------------------------------------------------
    def hasher(self, hasher: KmerHasher) -> "Builder":
        b = dataclasses.replace(self, _hasher=hasher)
        return b

    def super_kmers(self) -> "Builder":
        assert self.syncmer == _SYNCMER_NONE, "super-kmers are incompatible with syncmers"
        return dataclasses.replace(self, _super_kmers=True)

    def _resolved_hasher(self) -> KmerHasher:
        return self._hasher or NtHasher(self.k, canonical=self.canonical)

    @property
    def _out_length(self) -> int:
        return self.k + self.w - 1 if self.syncmer != _SYNCMER_NONE else self.k

    # -- execution ----------------------------------------------------------
    def run(self, seq, ambiguous: np.ndarray | None = None) -> Output:
        """Accelerated run on the JAX backend (the XLA pipeline)."""
        from .ops import backend, pipeline  # deferred: keep oracle paths jax-free

        seq = as_seq(seq)
        h = self._resolved_hasher()
        codes = seq.codes()
        if self.syncmer != _SYNCMER_NONE:
            mode = (
                pipeline.MODE_OPEN_SYNCMERS
                if self.syncmer == _SYNCMER_OPEN
                else pipeline.MODE_CLOSED_SYNCMERS
            )
            pos = backend.sketch(codes, self.k, self.w, h, mode=mode,
                                 ambiguous_np=ambiguous)
            return Output(self._out_length, seq, pos, canonical=self.canonical)
        if self._super_kmers:
            # the reference makes this combination unrepresentable
            # (super-kmers impl only for SYNCMER=0 without the ambiguity
            # stream, /root/reference/src/lib.rs:498-503) — assert rather
            # than silently computing something subtly different
            assert ambiguous is None, (
                "super_kmers cannot be combined with an ambiguity mask "
                "(unsupported in the reference; run without super_kmers "
                "or pre-split the sequence at ambiguous bases)"
            )
            pos, idx = backend.sketch(codes, self.k, self.w, h,
                                      mode=pipeline.MODE_SUPERKMERS)
            return Output(self._out_length, seq, pos, idx, canonical=self.canonical)
        pos = backend.sketch(codes, self.k, self.w, h, ambiguous_np=ambiguous)
        return Output(self._out_length, seq, pos, canonical=self.canonical)

    def run_scalar(self, seq, ambiguous: np.ndarray | None = None) -> Output:
        """NumPy-oracle run (reference's scalar path; for testing)."""
        seq = as_seq(seq)
        h = self._resolved_hasher()
        codes = seq.codes()
        sel = oracle.selected_stream(codes, self.k, self.w, h, ambiguous=ambiguous)
        if self.syncmer != _SYNCMER_NONE:
            pos = oracle.collect_syncmers(sel, self.w, self.syncmer == _SYNCMER_OPEN)
            return Output(self._out_length, seq, pos, canonical=self.canonical)
        if self._super_kmers:
            pos, idx = oracle.collect_and_dedup_with_index(sel)
            return Output(self._out_length, seq, pos, idx, canonical=self.canonical)
        pos = oracle.collect_and_dedup(sel, skip_sentinel=ambiguous is not None)
        return Output(self._out_length, seq, pos, canonical=self.canonical)

    def run_once(self, seq) -> np.ndarray:
        return self.run(seq).positions

    def run_scalar_once(self, seq) -> np.ndarray:
        return self.run_scalar(seq).positions

    def run_skip_ambiguous_windows(self, nseq: PackedNSeqVec) -> Output:
        """Skip windows containing non-ACGT bases
        (/root/reference/src/lib.rs:451-496)."""
        assert self.canonical, "skip-ambiguous is defined for canonical builders"
        out = self.run(nseq.seq, ambiguous=nseq.ambiguous.astype(np.uint8))
        return dataclasses.replace(out, seq=nseq.seq)

    def run_skip_ambiguous_windows_once(self, nseq: PackedNSeqVec) -> np.ndarray:
        return self.run_skip_ambiguous_windows(nseq).positions


# ---------------------------------------------------------------------------
# Builder constructors (reference src/lib.rs:240-321)
# ---------------------------------------------------------------------------


def minimizers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=False)


def canonical_minimizers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=True)


def closed_syncmers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=False, syncmer=_SYNCMER_CLOSED)


def canonical_closed_syncmers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=True, syncmer=_SYNCMER_CLOSED)


def open_syncmers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=False, syncmer=_SYNCMER_OPEN)


def canonical_open_syncmers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=True, syncmer=_SYNCMER_OPEN)


def minimizer_positions(seq, k: int, w: int) -> np.ndarray:
    """All deduplicated minimizer positions (/root/reference/src/lib.rs:639-641)."""
    return minimizers(k, w).run_once(seq)


def canonical_minimizer_positions(seq, k: int, w: int) -> np.ndarray:
    """Canonical minimizer positions; l = w+k-1 must be odd
    (/root/reference/src/lib.rs:652-654)."""
    return canonical_minimizers(k, w).run_once(seq)


def one_minimizer(window_seq, hasher: KmerHasher) -> int:
    """Minimizer position of a single window (/root/reference/src/minimizers.rs:22-28)."""
    return oracle.one_minimizer(as_seq(window_seq).codes(), hasher)


def _builder_run_batch(self, reads, ambiguous=None):
    """Sketch a batch of reads in one launch (an extension of the reference).

    reads: list of sequences (any accepted type). Returns (read_ids,
    positions[, superkmer indices]) ordered by read; positions are local
    to each read. Reads shorter than l = k + w - 1 have no windows and are
    dropped from the output entirely (their ids never appear). See
    ops/batch.sketch_batch.
    """
    from .ops import backend, pipeline

    # same unrepresentable combination as run(): super-kmers never carry
    # an ambiguity stream (/root/reference/src/lib.rs:498-503)
    assert not (self._super_kmers and ambiguous is not None), (
        "super_kmers cannot be combined with an ambiguity mask "
        "(unsupported in the reference; run without super_kmers "
        "or pre-split the reads at ambiguous bases)"
    )
    codes = [as_seq(r).codes() for r in reads]
    h = self._resolved_hasher()
    if self.syncmer != _SYNCMER_NONE:
        mode = (
            pipeline.MODE_OPEN_SYNCMERS
            if self.syncmer == _SYNCMER_OPEN
            else pipeline.MODE_CLOSED_SYNCMERS
        )
    elif self._super_kmers:
        mode = pipeline.MODE_SUPERKMERS
    else:
        mode = pipeline.MODE_MINIMIZERS
    return backend.sketch_batch(codes, self.k, self.w, h, mode=mode,
                                ambiguous=ambiguous)


Builder.run_batch = _builder_run_batch
