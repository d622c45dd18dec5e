"""Render tables and the (w, k) plot from a benchmark results JSON (the
reference's bench/eval.py).

Usage: python bench/eval.py results.json
"""

from __future__ import annotations

import json
import os
import sys

REF_AVX2 = {  # reference bench/results.json (BASELINE.md)
    (5, 31, False): 1.69, (5, 31, True): 2.28,
    (11, 21, False): 1.61, (11, 21, True): 2.20,
    (19, 19, False): 1.64, (19, 19, True): 2.16,
}
# (input, hasher, w, k, canonical) -> reference AVX2 ns/bp (BASELINE.md)
REF_EXT = {("packed", "nt", w, k, c): v for (w, k, c), v in REF_AVX2.items()}
REF_EXT.update({
    ("packed", "mul", 11, 21, False): 1.74, ("packed", "mul", 11, 21, True): 2.40,
    ("ascii-dna", "nt", 11, 21, False): 1.84, ("ascii-dna", "nt", 11, 21, True): 2.42,
    ("ascii", "mul", 11, 21, False): 2.06, ("ascii", "mul", 11, 21, True): 2.63,
})


def main():
    path = sys.argv[1]
    with open(path) as f:
        res = json.load(f)
    print(f"device: {res.get('device')}   n = {res.get('n'):,} bp\n")

    if "external" in res:
        print("== external: ns/bp (vs reference AVX2) ==")
        print(f"{'w':>3} {'k':>3} {'strand':>9} {'hasher':>6} {'input':>10} "
              f"{'ns/bp':>8} {'ref':>6} {'speedup':>8}")
        for r in res["external"]:
            inp = r.get("input", "packed")
            ref = REF_EXT.get((inp, r["hasher"], r["w"], r["k"], r["canonical"]))
            ref_s = f"{ref:.2f}" if ref else "-"
            sp = f"{ref / r['ns_per_bp']:.1f}x" if ref else "-"
            strand = "canonical" if r["canonical"] else "fwd"
            print(f"{r['w']:>3} {r['k']:>3} {strand:>9} {r['hasher']:>6} "
                  f"{inp:>10} {r['ns_per_bp']:>8.4f} {ref_s:>6} {sp:>8}")
        print()

    if "incremental" in res:
        print("== incremental: cumulative stage cost, XLA pipeline ==")
        prev = 0.0
        for r in res["incremental"]:
            delta = r["ns_per_bp"] - prev if r["backend"] == "xla" else None
            d = f" (+{delta:.3f})" if delta is not None and prev else ""
            print(f"  {r['stage']:>14}: {r['ns_per_bp']:.4f} ns/bp{d}")
            if r["backend"] == "xla":
                prev = r["ns_per_bp"]
        print()

    if "short" in res:
        print("== short sequences: per-call latency (single seq) ==")
        for r in res["short"]:
            if r.get("persistent_program"):
                print(f"  len {r['len']:>8}: persistent AOT program — "
                      f"{r['dispatch_floor_us']:.0f} us/call with transfer, "
                      f"{r.get('device_floor_us') or float('nan'):.0f} us "
                      f"device floor, {r['sync_roundtrip_us']:.0f} us "
                      f"sync round trip")
                continue
            if r.get("batched"):
                continue  # rendered in the amortized table below
            print(f"  len {r['len']:>8}: {r['us_per_seq']:>9.1f} us/seq "
                  f"({r['ns_per_bp']:.2f} ns/bp)")
        print()
        batched = [r for r in res["short"] if r.get("batched")]
        if batched:
            print("== short sequences AMORTIZED (run_batch, one launch; "
                  "the reference's short table is itself amortized — "
                  "ref NEON: 21.4 ns/bp @16bp ... 2.82 @8192) ==")
            for r in batched:
                print(f"  {r['reads']:>8} x {r['len']:>5}bp: "
                      f"{r['ns_per_bp']:.4f} ns/bp "
                      f"({r['reads_per_s']/1e6:.2f} M seqs/s)")
            print()

    if "batch" in res:
        print("== batched short reads (one launch per stride bucket) ==")
        for r in res["batch"]:
            print(f"  {r['reads']:>7} x {r['len']:>5}bp: {r['ns_per_bp']:.4f} ns/bp "
                  f"({r['reads_per_s']/1e6:.2f} M reads/s)")
        print()

    if isinstance(res.get("local_scalar"), list):
        print("== local scalar baseline: C++ single-core, MEASURED on this "
              "host (bench/cpu_scalar.cpp) ==")
        for r in res["local_scalar"]:
            strand = "canonical" if r["canonical"] else "fwd"
            print(f"  {r['alg']:>7} {strand:>9} k={r['k']} w={r['w']}: "
                  f"{r['ns_per_bp']:>8.3f} ns/bp")
        print()

    if "sliding_min_comparisons" in res:
        print("== sliding-min comparisons/element (algorithm zoo) ==")
        for k, v in res["sliding_min_comparisons"].items():
            print(f"  {k:>8}: {v:.2f}")
        print()

    if "human_genome" in res:
        h = res["human_genome"]
        print(f"human genome ({h['source']}, {h['n']/1e9:.2f} Gbp): "
              f"{h['count']:,} minimizers, density {h['density']}")
        if "device_s_measured" in h:
            print(f"  device {h['device_s_measured']}s MEASURED "
                  f"({h['gbp_per_s_device']} Gbp/s, {h['calls']} calls)")
        if "wall_s" in h:
            print(f"  wall {h['wall_s']}s end-to-end")
        print()

    if "fasta_e2e" in res:
        f = res["fasta_e2e"]
        print(f"FASTA end-to-end ({f['source']}, {f['records']} records, "
              f"{f['bp']/1e9:.2f} Gbp): parse {f['parse_s']}s + warm "
              f"sketch {f['sketch_s']}s = {f['value']} Gbp/s "
              f"(cold first-sketch {f.get('sketch_cold_s', '?')}s incl. "
              f"compilation; density {f['density']})")
        print()

    if "plot" in res:
        n_ours = sum(1 for r in res["plot"] if r["name"].startswith("smtpu"))
        png = render_plot(res["plot"], os.path.dirname(path) or ".")
        print(f"(w,k) sweep: {n_ours} measured rows + carried baselines "
              f"-> {png}\n")

    if "density" in res:
        d = res["density"]
        print(f"density: {d['density']} (expected ~{d['expected']})")


# Fixed categorical assignment (dataviz palette slots, never cycled):
# color follows the algorithm identity across every panel and filter.
_SERIES = [
    ("smtpu-xla", "#eb6834", "smtpu XLA pipeline (GPU)"),
    ("simd-minimizers", "#1baf7a", "simd-minimizers (AVX2, carried)"),
    ("rescan", "#eda100", "rescan (AVX2, carried)"),
    ("minimizer-iter", "#e87ba4", "minimizer-iter (AVX2, carried)"),
    ("scalar-queue", "#8c6ff0", "scalar queue (this host, measured)"),
]


def _series_name(row):
    return row["name"].replace("canonical ", "")


def render_plot(rows, outdir):
    """results-plot.png: ns/bp vs w, one panel per k (the reference's
    bench/eval.py plot, re-designed as small multiples instead of
    size-encoded overlays)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.lines import Line2D

    ks = sorted({r["k"] for r in rows})
    fig, axes = plt.subplots(1, len(ks), figsize=(3.4 * len(ks), 3.6),
                             sharey=True, sharex=True)
    if len(ks) == 1:
        axes = [axes]
    fig.patch.set_facecolor("#fcfcfb")
    for ax, k in zip(axes, ks):
        ax.set_facecolor("#fcfcfb")
        for name, color, _ in _SERIES:
            for canonical, ls in ((False, "-"), (True, "--")):
                pts = sorted(
                    (r["w"], r["ns_per_bp"]) for r in rows
                    if r["k"] == k and _series_name(r) == name
                    and bool(r.get("canonical")) == canonical)
                if not pts:
                    continue
                ax.plot([p[0] for p in pts], [p[1] for p in pts], ls,
                        color=color, lw=2, marker="o", ms=4)
        ax.set_yscale("log", base=2)
        ax.set_title(f"k = {k}", color="#0b0b0b", fontsize=11)
        ax.set_xlabel("w", color="#52514e")
        ax.grid(axis="y", which="major", color="#e4e3de", lw=0.8)
        ax.grid(axis="y", which="minor", color="#f0efe9", lw=0.6)
        ax.tick_params(colors="#52514e", labelsize=9)
        for s in ax.spines.values():
            s.set_color("#e4e3de")
    axes[0].set_ylabel("time (ns/bp, log scale)", color="#52514e")
    present = {_series_name(r) for r in rows}
    handles = [Line2D([], [], color=c, lw=2, label=lbl)
               for name, c, lbl in _SERIES if name in present]
    handles += [Line2D([], [], color="#52514e", lw=2, ls="-", label="forward"),
                Line2D([], [], color="#52514e", lw=2, ls="--", label="canonical")]
    fig.legend(handles=handles, loc="upper center",
               bbox_to_anchor=(0.5, 0.02), ncol=4, frameon=False,
               fontsize=9, labelcolor="#0b0b0b")
    out = os.path.join(outdir, "results-plot.png")
    fig.savefig(out, bbox_inches="tight", dpi=200)
    plt.close(fig)
    return out


if __name__ == "__main__":
    main()
