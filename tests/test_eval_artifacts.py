"""bench/eval.py renderers stay runnable (tables + plot artifact)."""

import json
import os
import subprocess
import sys

import numpy as np

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench")


def test_eval_tables_and_plot(tmp_path):
    sys.path.insert(0, BENCH)
    import eval as ev  # noqa: A004

    rows = []
    for name in ("simd-minimizers", "canonical simd-minimizers", "rescan"):
        for k in (5, 19):
            for w in (1, 11, 49):
                rows.append({"name": name, "k": k, "w": w,
                             "canonical": name.startswith("canonical"),
                             "ns_per_bp": 2.0 + 0.01 * w, "source": "carried-avx2"})
    rows += [{"name": "smtpu-xla", "k": 19, "w": w, "canonical": True,
              "ns_per_bp": 0.22} for w in (1, 11, 49)]
    png = ev.render_plot(rows, str(tmp_path))
    assert os.path.exists(png) and os.path.getsize(png) > 10_000

    res = {"device": "test", "n": 10**6,
           "external": [{"w": 11, "k": 21, "canonical": True, "hasher": "nt",
                         "input": "packed", "ns_per_bp": 0.22}],
           "plot": rows,
           "human_genome": {"source": "synthetic-device", "n": 3_100_000_000,
                            "count": 5, "density": 0.1667, "calls": 2,
                            "device_s_measured": 0.7, "gbp_per_s_device": 4.4}}
    p = tmp_path / "results.json"
    p.write_text(json.dumps(res))
    out = subprocess.run([sys.executable, os.path.join(BENCH, "eval.py"), str(p)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "external" in out.stdout and "MEASURED" in out.stdout
