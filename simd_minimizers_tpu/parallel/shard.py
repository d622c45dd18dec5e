"""Multi-device sketching: shard_map over a device mesh.

The sequence is split into per-device spans (each a lane matrix of
R rows x C windows, with l-1 char halos). Every device computes its own
selected-window stream; the one value of cross-device state — the previous
raw window value for the adjacent-dedup seam — moves between neighbouring
devices via `jax.lax.ppermute` (NCCL on GPUs). Outputs stay sharded as
(buffer, count) ragged pairs; the host (or an all_gather for device-side
consumers) concatenates.

This generalizes the reference's 8-lane + cross-lane-seam-dedup design
(/root/reference/src/collect.rs:252-272) to a device mesh, and realizes
the multi-host plan of SURVEY.md §2.4 / BASELINE.json config 5.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..hashers import KmerHasher
from ..ops import pipeline
from ..ops.pipeline import (
    INVALID,
    SKIPPED,
    MODE_CLOSED_SYNCMERS,
    MODE_MINIMIZERS,
    MODE_OPEN_SYNCMERS,
    MODE_SUPERKMERS,
    TracedHasher,
    U32,
    compact_flat,
    flat_length,
    hasher_jit_args,
    selected_window_stream_2d,
)

AXIS = "data"


def default_mesh(n_devices: int | None = None, local_only: bool = False) -> Mesh:
    """Mesh over the data axis; local_only restricts to this process's
    devices (per-host sketching inside a multi-process program)."""
    devs = jax.local_devices() if local_only else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (AXIS,))


def _device_body(codes, n_loc, offset, ambiguous, table, mul_const,
                 *, k, w, mode, skip_ambiguous, hasher_key, C, R, ndev):
    """Per-device computation inside shard_map. Leading axis is 1."""
    kind, canonical, rot_offset = hasher_key
    hasher = TracedHasher(kind, k, canonical, rot_offset, table, mul_const)
    sel, valid, widx = selected_window_stream_2d(
        codes[0], n_loc[0], offset[0], k, w, hasher, C, R,
        ambiguous[0] if skip_ambiguous else None,
    )
    gw = widx.astype(U32) + offset[0].astype(U32)
    nw_valid = jnp.maximum(n_loc[0] - (k + w - 1) + 1, 1)
    last_raw = sel[jnp.minimum(nw_valid - 1, sel.shape[0] - 1)]
    if mode in (MODE_CLOSED_SYNCMERS, MODE_OPEN_SYNCMERS):
        if mode == MODE_OPEN_SYNCMERS:
            is_sync = sel == gw + U32(w // 2)
        else:
            is_sync = (sel == gw) | (sel == gw + U32(w - 1))
        keep = valid & is_sync & (sel != SKIPPED)
        out, count = compact_flat(gw, keep, R, C)
        return out[None], count[None]
    # seam dedup: previous device's last raw window value
    prev_last = jax.lax.ppermute(last_raw, AXIS, [(i, i + 1) for i in range(ndev - 1)])
    prev_last = jnp.where(jax.lax.axis_index(AXIS) == 0, INVALID, prev_last)
    prev = jnp.concatenate([prev_last.reshape(1), sel[:-1]])
    keep = valid & (sel != prev)
    if skip_ambiguous:
        keep = keep & (sel != SKIPPED)
    if mode == MODE_SUPERKMERS:
        out, count = compact_flat(sel, keep, R, C)
        idx, _ = compact_flat(gw, keep, R, C)
        return out[None], idx[None], count[None]
    out, count = compact_flat(sel, keep, R, C)
    return out[None], count[None]


@functools.partial(
    jax.jit,
    static_argnames=("k", "w", "mode", "skip_ambiguous", "hasher_key", "C", "R", "mesh"),
)
def _jit_sharded(codes, n_loc, offsets, ambiguous, table, mul_const,
                 *, k, w, mode, skip_ambiguous, hasher_key, C, R, mesh):
    ndev = mesh.shape[AXIS]
    body = functools.partial(
        _device_body, k=k, w=w, mode=mode, skip_ambiguous=skip_ambiguous,
        hasher_key=hasher_key, C=C, R=R, ndev=ndev,
    )
    out_specs = (P(AXIS), P(AXIS), P(AXIS)) if mode == MODE_SUPERKMERS else (P(AXIS), P(AXIS))
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(), P()),
        out_specs=out_specs,
        check_vma=False,
    )(codes, n_loc, offsets, ambiguous, table, mul_const)


def sharded_sketch(
    codes_np: np.ndarray,
    k: int,
    w: int,
    hasher: KmerHasher,
    mode: str = MODE_MINIMIZERS,
    ambiguous_np: np.ndarray | None = None,
    mesh: Mesh | None = None,
    C: int = 1024,
):
    """Sketch one long sequence across all devices of the mesh.

    Each device owns an equal span of windows (the last padded); returns the
    bit-exact global position list (host-concatenated).
    """
    mesh = mesh or default_mesh()
    ndev = int(mesh.shape[AXIS])
    l = k + w - 1
    n = int(codes_np.shape[0])
    empty = np.zeros(0, dtype=np.uint32)
    if n < l:
        return (empty, empty) if mode == MODE_SUPERKMERS else empty
    nw = n - l + 1
    per_dev = -(-nw // ndev)
    Cg = min(C, max(16, 1 << (per_dev - 1).bit_length()))
    R = max(1, -(-per_dev // Cg))
    R = 1 << (R - 1).bit_length()
    FLAT = flat_length(Cg, R, l)

    skip_ambiguous = ambiguous_np is not None
    codes = np.zeros((ndev, FLAT), dtype=np.uint8)
    # the body reads the ambiguity plane only when skipping
    ambiguous = np.zeros((ndev, FLAT if skip_ambiguous else 1), dtype=np.uint8)
    n_loc = np.zeros(ndev, dtype=np.int32)
    offsets = np.zeros(ndev, dtype=np.uint32)
    for d in range(ndev):
        s = d * per_dev
        e = min(s + per_dev, nw)
        if s >= nw:
            continue
        chars_end = min(e - 1 + l, n)
        codes[d, : chars_end - s] = codes_np[s:chars_end]
        if skip_ambiguous:
            ambiguous[d, : chars_end - s] = ambiguous_np[s:chars_end]
        n_loc[d] = chars_end - s
        offsets[d] = s

    key, table, mul_const = hasher_jit_args(hasher)
    # each device receives only its own span, straight from the host
    spans = NamedSharding(mesh, P(AXIS))
    res = _jit_sharded(
        *(jax.device_put(x, spans) for x in (codes, n_loc, offsets, ambiguous)),
        jnp.asarray(table), jnp.asarray(mul_const),
        k=k, w=w, mode=mode, skip_ambiguous=skip_ambiguous,
        hasher_key=key, C=Cg, R=R, mesh=mesh,
    )
    if mode == MODE_SUPERKMERS:
        out, idx, counts = (np.asarray(x) for x in res)
        pos = np.concatenate([out[d, : counts[d]] for d in range(ndev)])
        sk = np.concatenate([idx[d, : counts[d]] for d in range(ndev)])
        return pos, sk
    out, counts = (np.asarray(x) for x in res)
    return np.concatenate([out[d, : counts[d]] for d in range(ndev)])
