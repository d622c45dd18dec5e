"""Headline benchmark: canonical minimizers, k=21 w=11, random DNA.

Mirrors the reference's paper benchmark config (k=21, w=11, n=10^8 random
bp, best-of-repeats; /root/reference/bench/src/bin/paper.rs:19-25,536-556).
Baseline to beat: 2.20 ns/bp canonical on AVX2 x86-64 (BASELINE.md).

Times `canonical_minimizers(21, 11).run(seq)` end to end through the
public API on a PackedSeqVec: host unpacking, upload, the chunked XLA
pipeline on the GPU and the download of the positions. Refuses to run
without a GPU.

    python bench.py [--trace DIR]

stderr: the card's name and power limit, cold and warm times; with
--trace, a jax.profiler trace of one warm run and its top device ops.
stdout: ONE JSON line
  {"metric": "canonical_k21_w11_ns_per_bp", "value": N, "unit": "ns/bp",
   "vs_baseline": baseline/value, "device": {...}, ...}
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np

BASELINE_NS_PER_BP = 2.20  # canonical k=21 w=11, AVX2 (BASELINE.md)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", metavar="DIR",
                    help="also trace one warm run into DIR")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform}")

    import simd_minimizers_tpu as sm
    from simd_minimizers_tpu.utils import profiling

    print(f"[bench] card: {profiling.card_info()}", file=sys.stderr)
    k, w, n, repeats = 21, 11, 10**8, 5
    rng = np.random.default_rng(0xBEEF)
    seq = sm.PackedSeqVec.from_codes(rng.integers(0, 4, n, dtype=np.uint8))
    builder = sm.canonical_minimizers(k, w)

    t0 = time.perf_counter()
    out = builder.run(seq)
    cold = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = builder.run(seq)
        times.append(time.perf_counter() - t0)
    best = min(times)
    count = int(out.positions.size)
    density = count / (n - k - w + 2)
    print(f"[bench] cold {cold:.3f}s; warm runs {[round(t, 4) for t in times]}"
          f" s; count={count} density={density:.4f} "
          f"(expect ~{2 / (w + 1):.4f})", file=sys.stderr)
    if args.trace:
        with profiling.trace(args.trace):
            builder.run(seq)
        red = profiling.device_op_totals(args.trace)
        print(f"[bench] trace: device busy {red['busy_ns'] / 1e6:.2f} ms of "
              f"a {red['window_ns'] / 1e6:.2f} ms op window", file=sys.stderr)
        for name, ns, cnt in red["ops"][:15]:
            print(f"[bench]   {ns / 1e6:10.3f} ms  x{cnt:<5d} {name}",
                  file=sys.stderr)
    ns_per_bp = best * 1e9 / n
    print(json.dumps({
        "metric": "canonical_k21_w11_ns_per_bp",
        "value": ns_per_bp,
        "unit": "ns/bp",
        "vs_baseline": BASELINE_NS_PER_BP / ns_per_bp,
        "median_ns_per_bp": statistics.median(times) * 1e9 / n,
        "cold_s": cold,
        "count": count,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
