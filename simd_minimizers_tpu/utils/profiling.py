"""Profiling helpers (the reference ships perf/flamegraph recipes,
/root/reference/bench/benches/justfile; here: jax.profiler traces, their
reduction to per-op device time, and the card's identity).
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os
import subprocess


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace around a block; view with XProf/TensorBoard."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def card_info() -> str:
    """`name, power.limit` of the first GPU as nvidia-smi reports them.

    Runs in a child process that stays off JAX; the card's power limit
    bounds its clocks, so every timing is reported beside it.
    """
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def device_op_totals(logdir: str) -> dict:
    """Reduce the newest trace under `logdir` to per-op device time.

    Reads the GPU planes of the `.xplane.pb`: the "XLA Ops" line when the
    trace has one, else every stream line. Returns {"ops": [(name,
    total_ns, count), ...] sorted by total time, "busy_ns": union of the
    op intervals, "window_ns": first op start to last op end}.
    """
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(
        logdir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {logdir}")
    data = ProfileData.from_file(paths[-1])
    totals: dict = collections.defaultdict(lambda: [0, 0])
    spans = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        ops = [ln for ln in lines if ln.name == "XLA Ops"]
        for line in ops or [ln for ln in lines if ln.name.startswith("Stream")]:
            for ev in line.events:
                t = totals[ev.name]
                t[0] += ev.duration_ns
                t[1] += 1
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (max(e for _, e in spans) - spans[0][0]) if spans else 0.0
    ops_sorted = sorted(((n, t[0], t[1]) for n, t in totals.items()),
                        key=lambda x: -x[1])
    return {"ops": ops_sorted, "busy_ns": busy, "window_ns": window}
