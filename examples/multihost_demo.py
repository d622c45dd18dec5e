"""Two-process multi-host sketch demo (BASELINE config 5 on one machine).

A CPU demo: both processes are pinned to the CPU, so they never contend
for a GPU (a JAX process reserves most of a card's memory when it starts).
Spawns 2 JAX processes (4 virtual CPU devices each) that call
`multihost_sketch` identically; each sketches its genome shard on its
local mesh, shards all-gather over the distributed runtime, and both
processes print the identical bit-exact global position list, verified
against the NumPy oracle.

    python examples/multihost_demo.py [n_chars]
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["SMTPU_REPO"])
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address="127.0.0.1:9911",
    num_processes=2,
    process_id=int(os.environ["SMTPU_PID"]),
)
import numpy as np
from simd_minimizers_tpu.hashers import NtHasher
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu.parallel import multihost

n = int(os.environ.get("SMTPU_N", "50000"))
rng = np.random.default_rng(77)
codes = rng.integers(0, 4, n, dtype=np.uint8)  # same data on both hosts
k, w = 21, 11
h = NtHasher(k, canonical=True)
got = multihost.multihost_sketch(codes, k, w, h)
want = oracle.collect_and_dedup(oracle.selected_stream(codes, k, w, h))
np.testing.assert_array_equal(got, want)
print(f"[process {jax.process_index()}] {got.size} positions, bit-exact", flush=True)

# non-minimizer modes across REAL processes: the tuple-aware ragged
# all-gather (superkmers) and the skip-ambiguous seam merge
got_p, got_i = multihost.multihost_sketch(codes, k, w, h, mode="superkmers")
want_p, want_i = oracle.collect_and_dedup_with_index(
    oracle.selected_stream(codes, k, w, h))
np.testing.assert_array_equal(got_p, want_p)
np.testing.assert_array_equal(got_i, want_i)
amb = (rng.random(n) < 0.005).astype(np.uint8)
got_a = multihost.multihost_sketch(codes, k, w, h, ambiguous_np=amb)
want_a = oracle.collect_and_dedup(
    oracle.selected_stream(codes, k, w, h, ambiguous=amb), skip_sentinel=True)
np.testing.assert_array_equal(got_a, want_a)
print(f"[process {jax.process_index()}] superkmers + skip-ambiguous bit-exact",
      flush=True)
"""


def main():
    n = sys.argv[1] if len(sys.argv) > 1 else "50000"
    env = dict(os.environ, SMTPU_REPO=REPO, SMTPU_N=n,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    procs = []
    for pid in (0, 1):
        e = dict(env, SMTPU_PID=str(pid))
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER], env=e))
    rc = [p.wait(timeout=600) for p in procs]
    if any(rc):
        raise SystemExit(f"worker exit codes {rc}")
    print("multihost demo: both processes produced the bit-exact global list")


if __name__ == "__main__":
    main()
