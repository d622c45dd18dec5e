"""Device k-mer value extraction vs the host NumPy path, bit-exact.

ops/device_values.py assembles values from a packed u32 word stream with
funnel shifts and computes canonical min(fwd, rc) with 2-bit-group
reversal; ops/values.py is the straightforward gather reference
(convention pinned by /root/reference/src/lib.rs:117-129).
"""

import numpy as np
import pytest

from simd_minimizers_tpu.ops import device_values as dv
from simd_minimizers_tpu.ops import values as hv

RNG = np.random.default_rng(0xDEC0DE)


def _random_case(n, m, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    return codes, rng


@pytest.mark.parametrize("k", [1, 2, 5, 15, 16, 17, 21, 31, 32])
@pytest.mark.parametrize("canonical", [False, True])
def test_values_u64_device_matches_host(k, canonical):
    n = 4000
    codes, rng = _random_case(n, 0, 0x100 + k)
    pos = rng.integers(0, n - k + 1, 300).astype(np.uint32)
    pos[:3] = [0, n - k, 1]  # exact boundary gathers
    got = dv.kmer_values_u64(codes, pos, k, canonical=canonical)
    if canonical:
        want = hv.canonical_kmer_values_u64(codes, pos, k)
    else:
        want = hv.kmer_values_u64(codes, pos, k)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [33, 48, 63, 64])
@pytest.mark.parametrize("canonical", [False, True])
def test_values_u128_device_matches_host(k, canonical):
    n = 6000
    codes, rng = _random_case(n, 0, 0x200 + k)
    pos = rng.integers(0, n - k + 1, 200).astype(np.uint32)
    pos[:2] = [0, n - k]
    got_lo, got_hi = dv.kmer_values_u128_limbs(codes, pos, k,
                                               canonical=canonical)
    if canonical:
        want_lo, want_hi = hv.canonical_kmer_values_u128_limbs(codes, pos, k)
    else:
        want_lo, want_hi = hv.kmer_values_u128_limbs(codes, pos, k)
    np.testing.assert_array_equal(got_lo, want_lo)
    np.testing.assert_array_equal(got_hi, want_hi)


def test_values_device_word_stream_and_empty():
    """Pre-packed word-stream input skips repacking; empty positions OK;
    device packing (pack_words_jnp) agrees with the host packer."""
    import jax.numpy as jnp

    n = 1000
    codes, rng = _random_case(n, 0, 7)
    words = dv.pack_words_np(codes)
    words_dev = np.asarray(dv.pack_words_jnp(jnp.asarray(codes)))
    np.testing.assert_array_equal(words[: words_dev.size - 4],
                                  words_dev[: words_dev.size - 4])
    pos = rng.integers(0, n - 21 + 1, 50).astype(np.uint32)
    np.testing.assert_array_equal(
        dv.kmer_values_u64(words, pos, 21, canonical=True),
        hv.canonical_kmer_values_u64(codes, pos, 21))
    assert dv.kmer_values_u64(codes, np.zeros(0, np.uint32), 21).size == 0


def test_values_device_on_sketch_output():
    """End-to-end: canonical minimizer positions -> device values equal
    the Output.values_u64 list (the reference doc-test config 5/7)."""
    import simd_minimizers_tpu as sm
    from simd_minimizers_tpu.seq.packed import PackedSeqVec

    ps = PackedSeqVec.from_ascii(b"ACGTGCTCAGAGACTCAGAGGA")
    out = sm.canonical_minimizers(5, 7).run(ps)
    got = dv.kmer_values_u64(ps.codes(), out.positions, 5, canonical=True)
    np.testing.assert_array_equal(got, np.asarray(out.values_u64(),
                                                  dtype=np.uint64))


def test_output_routes_to_device_values_at_scale(monkeypatch):
    """Output.values_u64/values_u128_limbs route 2-bit values through the
    device path when the sketch is large and the JAX backend is a GPU —
    bit-identical to the host path (the GPU is faked here; the device
    path itself runs on the CPU)."""
    import jax

    import simd_minimizers_tpu as sm
    from simd_minimizers_tpu import api
    from simd_minimizers_tpu.ops import device_values
    from simd_minimizers_tpu.seq.packed import PackedSeqVec

    rng = np.random.default_rng(0xD11)
    codes = rng.integers(0, 4, 5000, dtype=np.uint8)
    ps = PackedSeqVec.from_codes(codes)
    out = sm.canonical_minimizers(21, 11).run(ps)
    out128 = sm.canonical_minimizers(33, 7).run(ps)
    gs = sm.as_seq(b"general text here, not dna at all! " * 30)
    out_txt = sm.minimizers(4, 6).run(gs)
    host_u64 = out.values_u64()
    host_limbs = out128.values_u128_limbs()

    monkeypatch.setattr(api.Output, "DEVICE_VALUES_MIN", 1)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    calls = []
    orig = device_values.kmer_values_u64
    monkeypatch.setattr(device_values, "kmer_values_u64",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    assert out._use_device_values(32)
    np.testing.assert_array_equal(out.values_u64(), host_u64)
    assert calls, "values_u64 did not take the device route"
    got_limbs = out128.values_u128_limbs()
    np.testing.assert_array_equal(got_limbs[0], host_limbs[0])
    np.testing.assert_array_equal(got_limbs[1], host_limbs[1])
    # general text (8-bit) must NOT route to the 2-bit device path
    assert not out_txt._use_device_values(32)
    assert out_txt.values_u64().size == out_txt.positions.size


@pytest.mark.parametrize("platform,min_positions,routed", [
    ("cpu", 1, False),          # only a GPU backend takes the device route
    ("gpu", 1 << 40, False),    # below the size threshold: host gather
    ("gpu", 1, True),
])
def test_device_values_gate(monkeypatch, platform, min_positions, routed):
    import jax

    import simd_minimizers_tpu as sm
    from simd_minimizers_tpu import api

    codes = np.random.default_rng(0xD12).integers(0, 4, 3000, dtype=np.uint8)
    out = sm.canonical_minimizers(21, 11).run(sm.PackedSeqVec.from_codes(codes))
    monkeypatch.setattr(api.Output, "DEVICE_VALUES_MIN", min_positions)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert out._use_device_values(32) is routed
    assert not out._use_device_values(16)  # k = 21 > max_length


@pytest.mark.parametrize("k,canonical", [(1, False), (5, True), (21, True),
                                         (31, False), (32, True)])
def test_values_native_matches_numpy(k, canonical):
    """The native C++ extractor (the default host path for 2-bit codes)
    must be bit-identical to the pure-NumPy gather formulation."""
    from simd_minimizers_tpu import native

    if not native.available():
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(0xC11 + k)
    codes = rng.integers(0, 4, 5000, dtype=np.uint8)
    pos = np.sort(rng.choice(5000 - k, 700, replace=False).astype(np.uint32))
    got = native.kmer_values_u64(codes, pos, k, canonical=canonical)
    fwd = hv._chunked(
        lambda p: hv._pack_u64(hv._gather_windows(codes, p, k), 2), pos)
    if canonical:
        rc = hv._chunked(
            lambda p: hv._pack_u64(
                (hv._gather_windows(codes, p, k) ^ np.uint8(2))[:, ::-1], 2),
            pos)
        want = np.minimum(fwd, rc)
    else:
        want = fwd
    np.testing.assert_array_equal(got, want)
