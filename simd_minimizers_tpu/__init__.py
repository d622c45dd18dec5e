"""simd_minimizers_tpu — a minimizer sketching engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
`simd-minimizers` Rust crate: random minimizers, canonical minimizers,
super-k-mer intervals, and open/closed syncmers of DNA (and general ASCII)
sequences — computed as data-parallel array programs on a GPU, scaling
from one card to several cards and hosts via `jax.sharding`.

Quick start::

    import simd_minimizers_tpu as sm
    from simd_minimizers_tpu.seq.packed import PackedSeqVec

    ps = PackedSeqVec.from_ascii(b"ACGTGCTCAGAGACTCAGAGGA")
    sm.canonical_minimizer_positions(ps, k=5, w=7)      # -> [0, 7, 9, 15]

    out = sm.canonical_minimizers(5, 7).super_kmers().run(ps)
    out.positions, out.superkmer_indices, out.values_u64()
"""

import os as _os


def cache_dir(sub: str = "") -> str:
    """Per-user cache directory (0700) for compiled artifacts.

    Shared /tmp is not used: a world-writable predictable path would let
    another local user pre-plant a .so / jit cache entry.
    """
    root = _os.environ.get("XDG_CACHE_HOME") or _os.path.join(
        _os.path.expanduser("~"), ".cache"
    )
    d = _os.path.join(root, "smtpu", sub) if sub else _os.path.join(root, "smtpu")
    _os.makedirs(d, mode=0o700, exist_ok=True)
    return d


def compile_cache_dir() -> str:
    """Where JAX keeps compiled programs across processes.

    $JAX_COMPILATION_CACHE_DIR when set, else a fixed `.jax_cache` in the
    checkout (a fixed path: the path is part of the cache key).
    """
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


from .api import (
    Builder,
    Output,
    canonical_closed_syncmers,
    canonical_minimizer_positions,
    canonical_minimizers,
    canonical_open_syncmers,
    closed_syncmers,
    minimizer_positions,
    minimizers,
    one_minimizer,
    open_syncmers,
)
from .hashers import AntiLexHasher, KmerHasher, MulHasher, NtHasher
from .seq.packed import (
    AsciiSeq,
    AsciiSeqVec,
    GenericSeq,
    PackedNSeqVec,
    PackedSeq,
    PackedSeqVec,
    as_seq,
)

__version__ = "0.1.0"

__all__ = [
    "Builder",
    "Output",
    "minimizers",
    "canonical_minimizers",
    "closed_syncmers",
    "canonical_closed_syncmers",
    "open_syncmers",
    "canonical_open_syncmers",
    "minimizer_positions",
    "canonical_minimizer_positions",
    "one_minimizer",
    "KmerHasher",
    "NtHasher",
    "MulHasher",
    "AntiLexHasher",
    "PackedSeq",
    "PackedSeqVec",
    "AsciiSeq",
    "AsciiSeqVec",
    "GenericSeq",
    "PackedNSeqVec",
    "as_seq",
]
