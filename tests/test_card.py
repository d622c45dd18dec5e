"""Card-only differential checks: the compiled GPU pipeline vs the oracle.

The CPU suite covers semantics; these catch what only the GPU compiler can
get wrong (uint32 shift and compare lowering, gathers, the chunk and
device seams of compiled programs). Each check is a plain function, also
called in-process by chip_smoke.py phase (h). The tests skip unless JAX's
default device is a GPU:

    JAX_PLATFORMS=cuda python -m pytest -m card tests/test_card.py
"""

from __future__ import annotations

import numpy as np
import pytest

from simd_minimizers_tpu.hashers import AntiLexHasher, MulHasher, NtHasher
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu.utils.bits import rotl32_var_np

pytestmark = pytest.mark.card


def _want(codes, k, w, h, mode="minimizers", ambiguous=None):
    sel = oracle.selected_stream(codes, k, w, h, ambiguous=ambiguous)
    if mode == "superkmers":
        return oracle.collect_and_dedup_with_index(sel)
    if mode.endswith("syncmers"):
        return oracle.collect_syncmers(sel, w, mode == "open_syncmers")
    return oracle.collect_and_dedup(sel, skip_sentinel=ambiguous is not None)


def _assert_same(got, want, msg):
    if isinstance(want, tuple):
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g, wnt, err_msg=msg)
    else:
        np.testing.assert_array_equal(got, want, err_msg=msg)


def check_uint32_shifts():
    """Variable and static uint32 rotations/shifts (every amount 0..31)
    against NumPy: the pipeline's hashes are built from them."""
    import jax
    import jax.numpy as jnp

    from simd_minimizers_tpu.ops import pipeline

    rng = np.random.default_rng(0x5417)
    x = rng.integers(0, 1 << 32, 32 * 4096, dtype=np.uint32)
    r = np.tile(np.arange(32, dtype=np.uint32), 4096)
    got = np.asarray(jax.jit(pipeline._rotl)(jnp.asarray(x), jnp.asarray(r)))
    np.testing.assert_array_equal(got, rotl32_var_np(x, r))
    for s in (1, 15, 16, 17, 31):
        got = np.asarray(jax.jit(lambda v, s=s: (v << jnp.uint32(s))
                                 | (v >> jnp.uint32(32 - s)))(jnp.asarray(x)))
        np.testing.assert_array_equal(got, rotl32_var_np(x, np.full_like(x, s)))


def check_pipeline_fuzz():
    """Every mode and hasher through backend.sketch at several sizes."""
    from simd_minimizers_tpu.ops import backend

    rng = np.random.default_rng(0xF022)
    configs = [
        (21, 11, True, NtHasher, "minimizers", False),
        (5, 7, True, NtHasher, "minimizers", True),
        (31, 5, False, MulHasher, "minimizers", False),
        (19, 19, True, AntiLexHasher, "minimizers", False),
        (33, 7, True, AntiLexHasher, "minimizers", False),
        (21, 11, True, MulHasher, "minimizers", False),
        (5, 7, True, NtHasher, "superkmers", False),
        (11, 7, False, NtHasher, "closed_syncmers", False),
        (11, 7, False, NtHasher, "open_syncmers", False),
        (64, 3, False, NtHasher, "minimizers", False),
        (2, 2, True, NtHasher, "minimizers", False),
    ]
    for k, w, canonical, hcls, mode, amb_on in configs:
        n = int(rng.integers(40_000, 90_000))
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        amb = (rng.random(n) < 0.01).astype(np.uint8) if amb_on else None
        h = hcls(k, canonical=canonical)
        got = backend.sketch(codes, k, w, h, mode=mode, ambiguous_np=amb)
        _assert_same(got, _want(codes, k, w, h, mode, amb),
                     str((k, w, hcls.__name__, mode, amb_on)))
    h = NtHasher(21, canonical=True, seed=101010)
    codes = rng.integers(0, 4, 60_000, dtype=np.uint8)
    _assert_same(backend.sketch(codes, 21, 11, h), _want(codes, 21, 11, h),
                 "seeded nt")


def check_chunked_seams():
    """Compiled chunk streaming: the dedup seam carried between chunks in
    every mode, with ambiguity clustered at a seam."""
    from simd_minimizers_tpu.ops import chunked

    rng = np.random.default_rng(0x10E6)
    k, w = 21, 11
    codes = rng.integers(0, 4, 400_000, dtype=np.uint8)
    amb = np.zeros(codes.size, np.uint8)
    amb[149_990:150_010] = 1
    h = NtHasher(k, canonical=True)
    for mode, a in [("minimizers", None), ("superkmers", None),
                    ("closed_syncmers", None), ("minimizers", amb)]:
        got = chunked.sketch(codes, k, w, h, mode=mode, ambiguous_np=a,
                             chunk_windows=150_000)
        _assert_same(got, _want(codes, k, w, h, mode, a), mode)


def check_sharded_one_card():
    """shard_map + ppermute seam on the real (single-card) mesh."""
    from simd_minimizers_tpu.parallel import shard

    rng = np.random.default_rng(0x5A)
    codes = rng.integers(0, 4, 300_000, dtype=np.uint8)
    h = NtHasher(21, canonical=True)
    for mode in ("minimizers", "superkmers"):
        got = shard.sharded_sketch(codes, 21, 11, h, mode=mode)
        _assert_same(got, _want(codes, 21, 11, h, mode), mode)


def check_sketch_records():
    """Mixed record lengths: batch-routed small records, per-record big
    ones, empty and sub-window records."""
    from simd_minimizers_tpu.ops import backend

    rng = np.random.default_rng(0x2EC)
    lens = [0, 25, 120_000, 7000] + [int(m) for m in rng.integers(31, 3000, 12)]
    recs = [rng.integers(0, 4, m, dtype=np.uint8) for m in lens]
    h = NtHasher(21, canonical=True)
    for rec, got in zip(recs, backend.sketch_records(recs, 21, 11, h)):
        want = (_want(rec, 21, 11, h) if rec.size >= 31
                else np.zeros(0, np.uint32))
        _assert_same(got, want, f"record of {rec.size} bp")


def check_device_values():
    """On-device value assembly (funnel shifts, 2-bit-group reversal,
    u128 limbs) vs the host NumPy path."""
    from simd_minimizers_tpu.ops import device_values as dv
    from simd_minimizers_tpu.ops import values as hv

    rng = np.random.default_rng(0xDE7)
    codes = rng.integers(0, 4, 2_000_000, dtype=np.uint8)
    for k in (21, 31, 33, 64):
        pos = rng.integers(0, codes.size - k + 1, 100_000).astype(np.uint32)
        pos[:2] = [0, codes.size - k]
        if k <= 32:
            np.testing.assert_array_equal(
                dv.kmer_values_u64(codes, pos, k, canonical=True),
                hv.canonical_kmer_values_u64(codes, pos, k))
            np.testing.assert_array_equal(
                dv.kmer_values_u64(codes, pos, k), hv.kmer_values_u64(codes, pos, k))
        else:
            got = dv.kmer_values_u128_limbs(codes, pos, k, canonical=True)
            want = hv.canonical_kmer_values_u128_limbs(codes, pos, k)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


CHECKS = [check_uint32_shifts, check_pipeline_fuzz, check_chunked_seams,
          check_sharded_one_card, check_sketch_records, check_device_values]


@pytest.fixture
def card():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest -m card tests/test_card.py")


@pytest.mark.parametrize("check", CHECKS, ids=lambda f: f.__name__)
def test_on_card(card, check):
    check()
