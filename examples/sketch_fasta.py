"""End-to-end genome sketching CLI: FASTA in, minimizers out.

    python examples/sketch_fasta.py genome.fa --k 21 --w 11 --canonical \
        --out sketch.npz [--values] [--syncmers closed|open] [--skip-ambiguous]

Parses the FASTA with the native C++ scanner, sketches every record on
the GPU (the XLA pipeline; long records stream in chunks, many small ones
share batch launches), and writes positions (+ optional u64 values) per
record to an .npz.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("fasta")
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--w", type=int, default=11)
    ap.add_argument("--canonical", action="store_true")
    ap.add_argument("--values", action="store_true", help="also write u64 k-mer values")
    ap.add_argument("--syncmers", choices=["closed", "open"], default=None)
    ap.add_argument("--skip-ambiguous", action="store_true",
                    help="skip windows containing non-ACGT bases")
    ap.add_argument("--out", default="sketch.npz")
    args = ap.parse_args()

    from simd_minimizers_tpu.hashers import NtHasher
    from simd_minimizers_tpu.ops import backend, pipeline, values
    from simd_minimizers_tpu.seq.fasta import read_fasta

    mode = {None: pipeline.MODE_MINIMIZERS,
            "closed": pipeline.MODE_CLOSED_SYNCMERS,
            "open": pipeline.MODE_OPEN_SYNCMERS}[args.syncmers]
    h = NtHasher(args.k, canonical=args.canonical)
    t0 = time.perf_counter()
    recs = read_fasta(args.fasta)
    t1 = time.perf_counter()
    total_bp = sum(len(r) for r in recs)
    print(f"parsed {len(recs)} records, {total_bp/1e6:.1f} Mbp in {t1-t0:.2f}s",
          file=sys.stderr)

    out = {}
    total_pos = 0
    amb = ([r.ambiguous for r in recs] if args.skip_ambiguous else None)
    all_pos = backend.sketch_records([r.codes for r in recs], args.k, args.w,
                                     h, mode=mode, ambiguous=amb)
    for rec, pos in zip(recs, all_pos):
        out[f"{rec.name}/positions"] = pos
        total_pos += pos.size
        if args.values and mode == pipeline.MODE_MINIMIZERS:
            fn = (values.canonical_kmer_values_u64 if args.canonical
                  else values.kmer_values_u64)
            out[f"{rec.name}/values"] = fn(rec.codes, pos, args.k)
    t2 = time.perf_counter()
    np.savez_compressed(args.out, **out)
    print(f"sketched {total_pos} positions in {t2-t1:.2f}s "
          f"({total_bp/(t2-t1)/1e9:.2f} Gbp/s wall) -> {args.out}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
