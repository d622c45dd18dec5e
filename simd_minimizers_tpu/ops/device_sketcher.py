"""Pre-compiled sketcher for latency-sensitive short sequences.

For short inputs the per-call cost is host work, not device compute: jit
tracing and cache lookup, padding to a bucketed geometry, and one
synchronization per call. The reference's short-sequence numbers (8 KiB
in ~23 us on one CPU core, /root/reference/bench/src/bin/paper.rs:61-115)
are only approachable by removing every per-call host cost. This class
does that:

- ONE ahead-of-time compiled pipeline chunk (ops/pipeline._jit_chunk) per
  (k, w, hasher, mode) at a small fixed geometry (ROWS rows of C windows:
  8192 windows by default), so calls skip jit tracing and cache lookup;
- pre-staged constant operands (hash table, mul const, ambiguity stub);
- an async `launch`/`harvest` split so many short sequences can be
  enqueued back-to-back with one synchronization (the amortized
  per-call time is measured by `measure_floor`).

This is an explicit opt-in API rather than an automatic route in
`backend.sketch`: construct one sketcher per config up front (it compiles
once), then feed it sequences.
"""

from __future__ import annotations

import numpy as np

from ..hashers import KmerHasher
from . import pipeline
from .pipeline import MODE_MINIMIZERS, MODE_SUPERKMERS, hasher_jit_args

ROWS = 8  # lane rows of the fixed geometry


class ShortSeqSketcher:
    """Pre-compiled fixed-geometry pipeline program for short inputs."""

    def __init__(self, k: int, w: int, hasher: KmerHasher,
                 mode: str = MODE_MINIMIZERS, C: int = 1024):
        import jax.numpy as jnp

        self.k, self.w, self.mode = k, w, mode
        l = k + w - 1
        self._l = l
        self._C = C
        self.max_chars = ROWS * C + l - 1
        self._flat = pipeline.flat_length(C, ROWS, l)
        key, table, mul_const = hasher_jit_args(hasher)
        self._tab = jnp.asarray(table)
        self._mc = jnp.asarray(mul_const)
        self._amb = jnp.zeros(self._flat, jnp.uint8)
        self._prev = jnp.uint32(pipeline.INVALID_INT)
        # AOT compile once; calls skip tracing + jit cache lookup
        self._compiled = pipeline._jit_chunk.lower(
            jnp.zeros(self._flat, jnp.uint8), jnp.int32(0), jnp.uint32(0),
            self._prev, self._amb, self._tab, self._mc,
            k=k, w=w, mode=mode, skip_ambiguous=False, hasher_key=key,
            C=C, R=ROWS, rows=True,
        ).compile()

    def _device_codes(self, codes_np: np.ndarray):
        import jax.numpy as jnp

        buf = np.zeros(self._flat, np.uint8)
        buf[: codes_np.shape[0]] = codes_np
        return jnp.asarray(buf)

    def _run(self, codes_dev, n: int, offset: int):
        import jax.numpy as jnp

        return self._compiled(codes_dev, jnp.int32(n), jnp.uint32(offset),
                              self._prev, self._amb, self._tab, self._mc)

    # -- async pipeline -----------------------------------------------------
    def launch(self, codes_np: np.ndarray, offset: int = 0):
        """Enqueue one sketch; returns device handles (no sync)."""
        n = int(codes_np.shape[0])
        assert n <= self.max_chars, (
            f"ShortSeqSketcher(C={self._C}) handles up to {self.max_chars} "
            f"chars; route longer inputs through backend.sketch")
        if n < self._l:
            return None
        return self._run(self._device_codes(codes_np), n, offset)

    def harvest(self, handles):
        """Materialize one launch's positions (the only sync point)."""
        empty = np.zeros(0, np.uint32)
        if handles is None:
            return (empty, empty) if self.mode == MODE_SUPERKMERS else empty
        counts = np.asarray(handles[-2])
        planes = [pipeline.rows_to_flat(np.asarray(p), counts)
                  for p in handles[:-2]]
        return tuple(planes) if self.mode == MODE_SUPERKMERS else planes[0]

    # -- one-shot -----------------------------------------------------------
    def sketch(self, codes_np: np.ndarray):
        """Pad + run + return positions for one short sequence."""
        return self.harvest(self.launch(codes_np))

    def sketch_many(self, seqs):
        """Sketch a list of short sequences with pipelined dispatch:
        launch i+1 before harvesting i (one extra call in flight)."""
        outs = []
        pending = []
        for s in seqs:
            pending.append(self.launch(s))
            if len(pending) > 1:
                outs.append(self.harvest(pending.pop(0)))
        while pending:
            outs.append(self.harvest(pending.pop(0)))
        return outs

    # -- measurement --------------------------------------------------------
    def measure_floor(self, codes_np: np.ndarray, m: int = 50,
                      probes: int = 3) -> dict:
        """Per-call floor in microseconds, three numbers:

        - sync_us: one synchronized call (pad + transfer + compute +
          host round trip);
        - per_call_us: m launches enqueued back-to-back, one sync —
          cancels the sync latency but still pays a per-call host->device
          input transfer;
        - device_floor_us: the same compiled program re-invoked m times
          on a pre-staged device input — dispatch + device compute only.
        """
        import time

        assert m > 1, "m > 1: per_call_us is a (t_many - t_one)/(m-1) slope"
        n = int(codes_np.shape[0])
        assert n >= self._l, (
            f"input shorter than one window (l={self._l}): nothing to time")
        self.harvest(self.launch(codes_np))  # warm
        staged = self._device_codes(codes_np)

        def timed(call, mm):
            t0 = time.perf_counter()
            h = None
            for _ in range(mm):
                h = call()
            np.asarray(h[-2])
            return time.perf_counter() - t0

        def slope(call):
            t_one = min(timed(call, 1) for _ in range(probes))
            t_many = min(timed(call, m) for _ in range(probes))
            return t_one, (t_many - t_one) / (m - 1)

        t_sync, per_call = slope(lambda: self.launch(codes_np))
        _, per_dev = slope(lambda: self._run(staged, n, 0))
        return {
            "sync_us": t_sync * 1e6,
            "per_call_us": per_call * 1e6,
            "device_floor_us": per_dev * 1e6,
        }
