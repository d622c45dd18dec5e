"""Property tests for every hasher behavior derivable from the reference.

The `seq-hash` crate is unvendored; beyond the golden vectors these pin
the constraints its usage sites imply (SURVEY.md §2.2):

- canonical hash = fwd XOR rc (src/lib.rs:42): invariant under reverse
  complement — including k > 32 (u128-kmer territory) and k > 16 where
  AntiLexHasher only orders by its 16-char prefix.
- k-mer locality (`delay() < k`, src/minimizers.rs:84-91): a k-mer's hash
  depends only on its own k chars, so hashes of a slice equal the sliced
  hashes of the whole.
- seeded hashers (new_with_seed, src/lib.rs:143-160): deterministic per
  seed, different across seeds, and bit-identical on oracle and pipeline.
"""

import numpy as np
import pytest

from simd_minimizers_tpu.hashers import AntiLexHasher, MulHasher, NtHasher
from simd_minimizers_tpu.ops import oracle, pipeline

RNG = np.random.default_rng(0x4A54)
HASHERS = [NtHasher, MulHasher, AntiLexHasher]


@pytest.mark.parametrize("hcls", HASHERS)
@pytest.mark.parametrize("k", [1, 5, 16, 17, 31, 32, 33, 64])
def test_canonical_rc_invariance(hcls, k):
    codes = RNG.integers(0, 4, 300, dtype=np.uint8)
    h = hcls(k, canonical=True)
    fwd = h.hash_kmers_np(codes)
    rc = h.hash_kmers_np((codes ^ np.uint8(2))[::-1])
    np.testing.assert_array_equal(fwd, rc[::-1])


@pytest.mark.parametrize("hcls", HASHERS)
@pytest.mark.parametrize("k", [2, 21, 33])
def test_kmer_locality(hcls, k):
    codes = RNG.integers(0, 4, 200, dtype=np.uint8)
    h = hcls(k)
    full = h.hash_kmers_np(codes)
    s, e = 37, 150
    part = h.hash_kmers_np(codes[s:e])
    np.testing.assert_array_equal(part, full[s : e - k + 1])


@pytest.mark.parametrize("hcls", [NtHasher, MulHasher])
def test_seeded_hashers(hcls):
    k, w = 11, 7
    codes = RNG.integers(0, 4, 2000, dtype=np.uint8)
    base = {}
    for seed in [0, 1, 101010]:
        h = hcls(k, canonical=True, seed=seed)
        pos = oracle.collect_and_dedup(oracle.selected_stream(codes, k, w, h))
        # deterministic per seed
        h2 = hcls(k, canonical=True, seed=seed)
        np.testing.assert_array_equal(
            pos, oracle.collect_and_dedup(oracle.selected_stream(codes, k, w, h2)))
        # rc-invariance holds for every seed
        np.testing.assert_array_equal(
            h.hash_kmers_np(codes),
            h.hash_kmers_np((codes ^ np.uint8(2))[::-1])[::-1])
        base[seed] = pos
    assert not np.array_equal(base[0], base[1]), "seeds must differ"
    assert not np.array_equal(base[0], base[101010])


@pytest.mark.parametrize("hcls", [NtHasher, MulHasher])
def test_seeded_hashers_across_backends(hcls):
    """Seeded tables produce identical results on the oracle and the XLA
    pipeline."""
    k, w = 11, 5
    codes = RNG.integers(0, 4, 5000, dtype=np.uint8)
    for seed in [7, 4242]:
        h = hcls(k, canonical=True, seed=seed)
        want = oracle.collect_and_dedup(oracle.selected_stream(codes, k, w, h))
        got_xla = pipeline.run_pipeline(codes, k, w, h)
        np.testing.assert_array_equal(got_xla, want)


def test_default_nt_table_documented_scheme():
    """The reconstructed scheme: h(kmer) = XOR_j rotl32(T[c_j], (j+23)%32)
    with T = low 32 bits of the classic ntHash constants cyclically
    shifted in alphabetical order (hashers/__init__.py docstring). This
    pins the module constants against accidental drift."""
    from simd_minimizers_tpu.hashers import NT_ROT_OFFSET, NT_TABLE

    classic = {  # /root/reference/bench/src/nthash.rs:24-32 (A, C, G, T)
        "A": 0x3C8BFBB395C60474, "C": 0x3193C18562A02B4C,
        "G": 0x20323ED082572324, "T": 0x295549F54BE24456,
    }
    # alphabetical cyclic shift by one: A<-C, C<-G, G<-T, T<-A; 2-bit code
    # order is A=0, C=1, T=2, G=3
    want = [classic["C"], classic["G"], classic["A"], classic["T"]]
    np.testing.assert_array_equal(NT_TABLE, np.asarray(want, np.uint64) & 0xFFFFFFFF)
    assert NT_ROT_OFFSET == 23
