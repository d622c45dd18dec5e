"""Smoke test of the sketching path on an NVIDIA GPU, bit for bit.

    python chip_smoke.py                # phases (a)-(h) on one card
    python chip_smoke.py --four-cards   # only the sharded path, 4 cards

Drives the public entry points at real size, with data made from fixed
seeds, and compares every output exactly with the NumPy oracle
(ops/oracle.py) or the host value extractor (ops/values.py):

  a  device check: JAX's first device must be a GPU (no CPU fallback)
  b  canonical k=21 w=11 on 10^8 random bp (PackedSeqVec; more windows
     than backend.PIPELINE_CHUNK_WINDOWS, so it streams chunks)
  c  values_u64() of (b)'s output through the device route vs the host
  d  10^7 bp: forward MulHasher, super-k-mers, closed / open / canonical
     closed syncmers, skip-ambiguous with clustered N runs, general text
  e  backend.sketch_records over mixed record lengths (empty, sub-window,
     batch-routed small ones, one longer than 2^24 windows), then
     run_batch of 10^6 x 150 bp reads (a seeded 10^4 sample checked)
  f  large w: w=2047 at 10^7 bp, w=32767 at 2x10^6 bp
  g  ShortSeqSketcher on 1000 sequences of 64-8192 bp
  h  the card-only checks of tests/test_card.py, in-process

--four-cards runs shard.sharded_sketch over a 4-card mesh at 4x10^8 bp
(canonical minimizers, super-k-mers, skip-ambiguous) against a one-card
backend.sketch of the same sequence and against the oracle.

The oracle runs in blocks of windows on a pool of worker processes that
never import JAX, so one JAX process holds the card. Per-phase cold and
warm seconds and counts go to stdout; a failed phase prints its
traceback and the script exits non-zero. On success the last stdout line
is {"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
import traceback

import numpy as np

from simd_minimizers_tpu.hashers import MulHasher, NtHasher
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu.utils.bits import SKIPPED

FULL = dict(main_bp=10**8, modes_bp=10**7, reads=10**6, read_bp=150,
            read_sample=10**4, w2047_bp=10**7, w32767_bp=2 * 10**6,
            short_seqs=1000, short_max_bp=8192, per_card_bp=10**8)

_SYNCMERS = ("closed_syncmers", "open_syncmers")


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# The oracle, in blocks of windows
# ---------------------------------------------------------------------------


def _oracle_block(task):
    """Oracle output of the windows of one block, in global coordinates.

    A dedup block also carries the window before it (its first window):
    that window's output, if any, belongs to the previous block.
    """
    codes, amb, k, w, hasher, mode, s0, drop_first = task
    sel = oracle.selected_stream(codes, k, w, hasher, ambiguous=amb)
    if mode in _SYNCMERS:
        out = (oracle.collect_syncmers(sel, w, mode == "open_syncmers"),)
    elif mode == "superkmers":
        out = oracle.collect_and_dedup_with_index(sel)
    else:
        out = (oracle.collect_and_dedup(sel, skip_sentinel=amb is not None),)
    if drop_first and not (amb is not None and sel[0] == SKIPPED):
        out = tuple(a[1:] for a in out)
    return tuple(a.astype(np.uint32) + np.uint32(s0) for a in out)


def oracle_sketch(codes, k, w, hasher, mode="minimizers", ambiguous=None,
                  pool=None):
    """The oracle's whole output as a tuple of arrays (positions, plus the
    super-k-mer window indices), computed block by block on `pool`."""
    l = k + w - 1
    nw = codes.size - l + 1
    if nw <= 0:
        n_out = 2 if mode == "superkmers" else 1
        return tuple(np.zeros(0, np.uint32) for _ in range(n_out))
    block = min(1 << 21, max(1 << 14, -(-nw // 64)))
    tasks = []
    for s in range(0, nw, block):
        e = min(s + block, nw)
        s0 = s - 1 if (s > 0 and mode not in _SYNCMERS) else s
        amb = ambiguous[s0 : e + l - 1] if ambiguous is not None else None
        tasks.append((codes[s0 : e + l - 1], amb, k, w, hasher, mode, s0,
                      s0 != s))
    parts = pool.map(_oracle_block, tasks) if pool else map(_oracle_block, tasks)
    return tuple(np.concatenate(p) for p in zip(*parts))


def expect_equal(what: str, got, want) -> None:
    """Exact equality of two tuples of arrays, or AssertionError."""
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want), f"{what}: {len(got)} vs {len(want)} planes"
    for i, (g, wnt) in enumerate(zip(got, want)):
        g, wnt = np.asarray(g), np.asarray(wnt)
        if g.shape != wnt.shape or not np.array_equal(g, wnt):
            m = min(g.size, wnt.size)
            bad = np.flatnonzero(g[:m] != wnt[:m])
            first = int(bad[0]) if bad.size else m
            raise AssertionError(
                f"{what} plane {i}: got {g.size} values, want {wnt.size}; "
                f"first difference at index {first}")


def cold_warm(what: str, fn):
    """Run fn twice (cold: includes compilation; warm) and log both."""
    t0 = time.perf_counter()
    fn()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = fn()
    warm = time.perf_counter() - t0
    log(f"  {what}: cold {cold:.3f} s, warm {warm:.3f} s")
    return res, warm


def no_float_dot(k: int, w: int, hasher, mode: str) -> None:
    """The lowered pipeline chunk at the streaming geometry has no dot."""
    import jax

    from simd_minimizers_tpu.ops import backend, pipeline

    C = pipeline.DEFAULT_C
    R = backend.PIPELINE_CHUNK_WINDOWS // C
    key, table, mul_const = pipeline.hasher_jit_args(hasher)
    flat = jax.ShapeDtypeStruct((pipeline.flat_length(C, R, k + w - 1),),
                                np.uint8)
    scalar = lambda dt: jax.ShapeDtypeStruct((), dt)  # noqa: E731
    text = pipeline._jit_chunk.lower(
        flat, scalar(np.int32), scalar(np.uint32), scalar(np.uint32), flat,
        jax.ShapeDtypeStruct(table.shape, np.uint32), scalar(np.uint32),
        k=k, w=w, mode=mode, skip_ambiguous=False, hasher_key=key, C=C, R=R,
        rows=True).as_text()
    assert "stablehlo.dot" not in text, f"the {mode} chunk lowers to a dot"


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_main(sz, pool, state):
    """(b) canonical k=21 w=11 through chunked streaming."""
    import simd_minimizers_tpu as sm
    from simd_minimizers_tpu.ops import backend

    k, w, n = 21, 11, sz["main_bp"]
    assert n - k - w + 2 > backend.PIPELINE_CHUNK_WINDOWS, "too small to stream"
    codes = np.random.default_rng(1).integers(0, 4, n, dtype=np.uint8)
    seq = sm.PackedSeqVec.from_codes(codes)
    out, warm = cold_warm(f"canonical k={k} w={w} on {n} bp",
                          lambda: sm.canonical_minimizers(k, w).run(seq))
    h = NtHasher(k, canonical=True)
    expect_equal("canonical minimizers", out.positions,
                 oracle_sketch(codes, k, w, h, pool=pool))
    log(f"  count {out.positions.size}, density "
        f"{out.positions.size / (n - k - w + 2):.5f}, {warm * 1e9 / n:.4f} ns/bp warm")
    no_float_dot(k, w, h, "minimizers")
    no_float_dot(k, w, h, "superkmers")
    state["main"] = (codes, out)


def phase_values(sz, pool, state):
    """(c) values_u64 of (b) via the device route vs the host."""
    import jax

    from simd_minimizers_tpu.ops import values

    codes, out = state["main"]
    routed = out._use_device_values(32)
    log(f"  {out.positions.size} positions; device route: {routed}")
    if jax.default_backend() == "gpu":
        assert routed, "values_u64 did not take the device route"
    got, _ = cold_warm("values_u64", out.values_u64)
    expect_equal("values_u64", got, (values.canonical_kmer_values_u64(
        codes, out.positions, out.length),))


def phase_modes(sz, pool, state):
    """(d) the other modes and inputs at 10^7 bp."""
    import simd_minimizers_tpu as sm

    k, w, n = 21, 11, sz["modes_bp"]
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    ps = sm.PackedSeqVec.from_codes(codes)
    cases = [
        ("forward MulHasher", sm.minimizers(k, w).hasher(MulHasher(k)),
         MulHasher(k), "minimizers"),
        ("super-k-mers", sm.canonical_minimizers(k, w).super_kmers(),
         NtHasher(k, canonical=True), "superkmers"),
        ("closed syncmers", sm.closed_syncmers(k, w), NtHasher(k),
         "closed_syncmers"),
        ("open syncmers", sm.open_syncmers(k, w), NtHasher(k),
         "open_syncmers"),
        ("canonical closed syncmers", sm.canonical_closed_syncmers(k, w),
         NtHasher(k, canonical=True), "closed_syncmers"),
    ]
    for what, builder, h, mode in cases:
        out, _ = cold_warm(what, lambda b=builder: b.run(ps))
        got = ((out.positions, out.superkmer_indices) if mode == "superkmers"
               else out.positions)
        expect_equal(what, got, oracle_sketch(codes, k, w, h, mode, pool=pool))
        log(f"    count {out.positions.size}")

    # skip-ambiguous: N runs of 1..2000 bp clustered at 200 places
    ascii_ = np.frombuffer(b"ACTG", np.uint8)[codes]
    for start in rng.integers(0, n - 2000, 200):
        ascii_[start : start + int(rng.integers(1, 2001))] = ord("N")
    nseq = sm.PackedNSeqVec.from_ascii(ascii_)
    b = sm.canonical_minimizers(k, w)
    out, _ = cold_warm("skip-ambiguous",
                       lambda: b.run_skip_ambiguous_windows(nseq))
    expect_equal("skip-ambiguous", out.positions, oracle_sketch(
        nseq.seq.codes(), k, w, NtHasher(k, canonical=True),
        ambiguous=nseq.ambiguous.astype(np.uint8), pool=pool))
    log(f"    count {out.positions.size}, {int(nseq.ambiguous.sum())} N")

    text = rng.integers(32, 127, n, dtype=np.uint8)
    b = sm.minimizers(k, w).hasher(MulHasher(k))
    out, _ = cold_warm("general text, MulHasher", lambda: b.run(text.tobytes()))
    assert isinstance(out.seq, sm.GenericSeq)
    expect_equal("general text", out.positions,
                 oracle_sketch(text, k, w, MulHasher(k), pool=pool))


def phase_records(sz, pool, state):
    """(e) sketch_records on mixed lengths; run_batch of short reads."""
    import simd_minimizers_tpu as sm
    from simd_minimizers_tpu.ops import backend

    k, w = 21, 11
    l = k + w - 1
    h = NtHasher(k, canonical=True)
    rng = np.random.default_rng(3)
    lens = ([0, l - 1] + [int(m) for m in rng.integers(1000, 5000, 12)]
            + [backend.PIPELINE_CHUNK_WINDOWS + 1000 + l - 1])
    recs = [rng.integers(0, 4, m, dtype=np.uint8) for m in lens]
    small = sum(l <= m <= backend.RECORDS_BATCH_MAX_BP for m in lens)
    assert small >= backend.RECORDS_BATCH_MIN_COUNT, "no batch route"
    outs, _ = cold_warm(f"sketch_records ({len(recs)} records)",
                        lambda: backend.sketch_records(recs, k, w, h))
    for rec, got in zip(recs, outs):
        expect_equal(f"record of {rec.size} bp", got,
                     oracle_sketch(rec, k, w, h, pool=pool))

    B, L = sz["reads"], sz["read_bp"]
    reads = rng.integers(0, 4, (B, L), dtype=np.uint8)
    (rid, pos), warm = cold_warm(f"run_batch {B} x {L} bp", lambda: (
        sm.canonical_minimizers(k, w).run_batch(reads)))
    log(f"    {B / warm:.0f} reads/s warm, {pos.size} positions")
    sample = np.sort(rng.choice(B, min(sz["read_sample"], B), replace=False))
    starts = np.searchsorted(rid, sample.astype(rid.dtype))
    ends = np.searchsorted(rid, (sample + 1).astype(rid.dtype))
    for i, a, e in zip(sample, starts, ends):
        expect_equal(f"read {i}", pos[a:e], oracle_sketch(reads[i], k, w, h))


def phase_large_w(sz, pool, state):
    """(f) canonical k=21 at w=2047 and w=32767."""
    import simd_minimizers_tpu as sm

    k = 21
    for w, n in ((2047, sz["w2047_bp"]), (32767, sz["w32767_bp"])):
        codes = np.random.default_rng(w).integers(0, 4, n, dtype=np.uint8)
        ps = sm.PackedSeqVec.from_codes(codes)
        out, _ = cold_warm(f"w={w} on {n} bp",
                           lambda: sm.canonical_minimizers(k, w).run(ps))
        expect_equal(f"w={w}", out.positions, oracle_sketch(
            codes, k, w, NtHasher(k, canonical=True), pool=pool))
        log(f"    count {out.positions.size}")


def phase_short(sz, pool, state):
    """(g) the pre-compiled short-sequence sketcher."""
    from simd_minimizers_tpu.ops.device_sketcher import ShortSeqSketcher

    k, w = 21, 11
    h = NtHasher(k, canonical=True)
    rng = np.random.default_rng(4)
    seqs = [rng.integers(0, 4, int(m), dtype=np.uint8)
            for m in rng.integers(64, sz["short_max_bp"] + 1, sz["short_seqs"])]
    t0 = time.perf_counter()
    sk = ShortSeqSketcher(k, w, h)
    log(f"  compile {time.perf_counter() - t0:.3f} s")
    outs, _ = cold_warm(f"sketch_many of {len(seqs)}",
                        lambda: sk.sketch_many(seqs))
    for s, got in zip(seqs, outs):
        expect_equal(f"sequence of {s.size} bp", got,
                     oracle_sketch(s, k, w, h))
    log(f"  floor at {seqs[0].size} bp: {sk.measure_floor(seqs[0])}")


def phase_card_checks(sz, pool, state):
    """(h) tests/test_card.py's checks, in this process."""
    # by path: an installed package named `tests` may shadow the repo's
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))
    import test_card

    for check in test_card.CHECKS:
        t0 = time.perf_counter()
        check()
        log(f"  {check.__name__}: {time.perf_counter() - t0:.3f} s")


def phase_four_cards(sz, pool, state):
    """Sharded sketch over 4 cards vs one card and the oracle."""
    import jax

    from simd_minimizers_tpu.ops import backend
    from simd_minimizers_tpu.parallel import shard

    devs = jax.devices()
    assert len(devs) >= 4, f"needs 4 devices, JAX sees {len(devs)}"
    mesh = shard.default_mesh(4)
    k, w = 21, 11
    n = 4 * sz["per_card_bp"]
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    amb = np.zeros(n, np.uint8)
    for start in rng.integers(0, n - 2000, 400):
        amb[start : start + int(rng.integers(1, 2001))] = 1
    h = NtHasher(k, canonical=True)
    cases = [("canonical minimizers", "minimizers", None),
             ("super-k-mers", "superkmers", None),
             ("skip-ambiguous", "minimizers", amb)]
    sharded = []
    for what, mode, a in cases:
        got, _ = cold_warm(f"sharded {what} on {n} bp", lambda m=mode, a=a: (
            shard.sharded_sketch(codes, k, w, h, mode=m, ambiguous_np=a,
                                 mesh=mesh)))
        sharded.append(got)
        if what == cases[0][0] and devs[0].platform == "gpu":
            peaks = [d.memory_stats()["peak_bytes_in_use"] for d in devs[:4]]
            log(f"    peak device bytes: {peaks}")
            assert min(peaks) > max(peaks) // 2, "work did not spread"
    for (what, mode, a), got in zip(cases, sharded):
        one, _ = cold_warm(f"one-card {what}", lambda m=mode, a=a: (
            backend.sketch(codes, k, w, h, mode=m, ambiguous_np=a)))
        expect_equal(f"sharded vs one card, {what}", got, one if isinstance(
            one, tuple) else (one,))
        expect_equal(f"sharded vs oracle, {what}", got,
                     oracle_sketch(codes, k, w, h, mode, a, pool=pool))
        log(f"    count {np.asarray(got if mode != 'superkmers' else got[0]).size}")


PHASES = [("b", phase_main), ("c", phase_values), ("d", phase_modes),
          ("e", phase_records), ("f", phase_large_w), ("g", phase_short),
          ("h", phase_card_checks)]


def run_phases(phases, sz, pool) -> list[str]:
    """Run phases in order; returns the names of those that failed."""
    failed, state = [], {}
    for name, fn in phases:
        log(f"[{name}] {fn.__doc__.splitlines()[0]}")
        t0 = time.perf_counter()
        try:
            fn(sz, pool, state)
        except Exception:
            traceback.print_exc(file=sys.stdout)
            failed.append(name)
            log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s")
        else:
            log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    return failed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on a 4-card mesh")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import jax

    from simd_minimizers_tpu.utils.profiling import card_info

    dev = jax.devices()[0]
    log(f"[a] JAX {jax.__version__}: {len(jax.devices())} x {dev.platform} "
        f"({dev.device_kind})")
    if dev.platform != "gpu":
        print(f"[a] FAILED: no GPU (JAX found {dev.platform})", file=sys.stderr)
        return 1
    log(f"card: {card_info()}")
    phases = ([("four-cards", phase_four_cards)] if args.four_cards
              else PHASES)
    workers = max(1, (os.cpu_count() or 2) - 2)
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        failed = run_phases(phases, FULL, pool)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
