"""Multi-host sharding scheme: shard bounds, seam merge, end-to-end on one
process (shards emulated serially) == oracle."""

import numpy as np
import pytest

from simd_minimizers_tpu.hashers import NtHasher
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu.parallel import multihost

RNG = np.random.default_rng(0xD15)


def test_shard_bounds_cover_all_windows():
    n, l, S = 10007, 31, 4
    covered = []
    for s_id in range(S):
        s, e = multihost.shard_bounds(n, l, S, s_id)
        if e > s:
            covered.extend(range(s, e - l + 1))
    assert covered == list(range(n - l + 1))


@pytest.mark.parametrize("num_shards", [1, 2, 3, 7])
def test_emulated_multihost_matches_oracle(num_shards):
    k, w = 21, 11
    n = 30000
    codes = RNG.integers(0, 4, n, dtype=np.uint8)
    h = NtHasher(k, canonical=True)
    shards = [
        multihost.local_shard_sketch(codes, k, w, h, num_shards, s)
        for s in range(num_shards)
    ]
    got = multihost.merge_shard_positions(shards)
    want = oracle.collect_and_dedup(oracle.selected_stream(codes, k, w, h))
    np.testing.assert_array_equal(got, want)


def test_multihost_sketch_single_process():
    k, w = 5, 7
    codes = RNG.integers(0, 4, 5000, dtype=np.uint8)
    h = NtHasher(k)
    got = multihost.multihost_sketch(codes, k, w, h)
    want = oracle.collect_and_dedup(oracle.selected_stream(codes, k, w, h))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["minimizers", "superkmers",
                                  "closed_syncmers", "open_syncmers",
                                  "skip_ambiguous"])
@pytest.mark.parametrize("num_shards", [1, 3])
def test_multihost_layer_all_modes(mode, num_shards):
    """The multihost LAYER (local_shard_sketch + mode-aware merge) serves
    every mode the reference's one implementation does
    (/root/reference/src/lib.rs:427-436, :451-496) — not just minimizers."""
    from simd_minimizers_tpu.ops import pipeline

    k, w = 11, 7
    n = 20000
    codes = RNG.integers(0, 4, n, dtype=np.uint8)
    h = NtHasher(k, canonical=mode in ("minimizers", "superkmers", "skip_ambiguous"))
    amb = None
    kernel_mode = mode
    if mode == "skip_ambiguous":
        kernel_mode = "minimizers"
        amb = (RNG.random(n) < 0.005).astype(np.uint8)
    l = k + w - 1
    parts = [
        multihost.local_shard_sketch(codes, k, w, h, num_shards, s,
                                     mode=kernel_mode, ambiguous_np=amb)
        for s in range(num_shards)
    ]
    starts = [multihost.shard_bounds(n, l, num_shards, s)[0]
              for s in range(num_shards)]
    if kernel_mode == "superkmers":
        got = multihost._merge_mode_shards(
            [p[0] for p in parts], starts, codes, k, w, h, kernel_mode,
            amb, aux=[p[1] for p in parts])
    else:
        got = multihost._merge_mode_shards(
            parts, starts, codes, k, w, h, kernel_mode, amb)
    sel = oracle.selected_stream(codes, k, w, h, ambiguous=amb)
    if kernel_mode == "superkmers":
        want = oracle.collect_and_dedup_with_index(sel)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    elif kernel_mode.endswith("syncmers"):
        want = oracle.collect_syncmers(sel, w, kernel_mode == "open_syncmers")
        np.testing.assert_array_equal(got, want)
    else:
        want = oracle.collect_and_dedup(sel, skip_sentinel=amb is not None)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["superkmers", "closed_syncmers"])
def test_multihost_sketch_single_process_modes(mode):
    """multihost_sketch end-to-end (single process) in non-minimizer modes."""
    k, w = 5, 7
    codes = RNG.integers(0, 4, 5000, dtype=np.uint8)
    h = NtHasher(k)
    got = multihost.multihost_sketch(codes, k, w, h, mode=mode)
    sel = oracle.selected_stream(codes, k, w, h)
    if mode == "superkmers":
        want = oracle.collect_and_dedup_with_index(sel)
        assert isinstance(got, tuple), "superkmers must return a (pos, idx) tuple"
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    else:
        want = oracle.collect_syncmers(sel, w, False)
        np.testing.assert_array_equal(got, want)


def test_multihost_sketch_skip_ambiguous():
    k, w = 5, 7
    n = 5000
    codes = RNG.integers(0, 4, n, dtype=np.uint8)
    amb = (RNG.random(n) < 0.01).astype(np.uint8)
    h = NtHasher(k, canonical=True)
    got = multihost.multihost_sketch(codes, k, w, h, ambiguous_np=amb)
    want = oracle.collect_and_dedup(
        oracle.selected_stream(codes, k, w, h, ambiguous=amb), skip_sentinel=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["minimizers", "superkmers",
                                  "closed_syncmers", "open_syncmers",
                                  "skip_ambiguous"])
def test_sharded_all_modes_on_mesh(mode):
    """The sharded pipeline under shard_map (8-dev CPU mesh) supports every
    reference mode (src/lib.rs:427-436, :475-482)."""
    from simd_minimizers_tpu.parallel import shard

    k, w = 11, 7
    n = 30000
    codes = RNG.integers(0, 4, n, dtype=np.uint8)
    h = NtHasher(k, canonical=mode in ("minimizers", "superkmers", "skip_ambiguous"))
    mesh = shard.default_mesh()
    amb = None
    kernel_mode = mode
    if mode == "skip_ambiguous":
        kernel_mode = "minimizers"
        amb = (RNG.random(n) < 0.005).astype(np.uint8)
    got = shard.sharded_sketch(codes, k, w, h, mode=kernel_mode,
                               ambiguous_np=amb, mesh=mesh)
    sel = oracle.selected_stream(codes, k, w, h, ambiguous=amb)
    if mode == "superkmers":
        want = oracle.collect_and_dedup_with_index(sel)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    elif mode.endswith("syncmers"):
        want = oracle.collect_syncmers(sel, w, mode == "open_syncmers")
        np.testing.assert_array_equal(got, want)
    else:
        want = oracle.collect_and_dedup(sel, skip_sentinel=amb is not None)
        np.testing.assert_array_equal(got, want)


def test_sharded_with_empty_trailing_shards():
    """nw < ndev: trailing devices get ZERO windows and must produce empty
    outputs without breaking the seam chain."""
    from simd_minimizers_tpu.parallel import shard

    k, w = 5, 7
    l = k + w - 1
    codes = RNG.integers(0, 4, l + 4, dtype=np.uint8)  # nw = 5 < 8 devices
    h = NtHasher(k, canonical=True)
    mesh = shard.default_mesh()
    got = shard.sharded_sketch(codes, k, w, h, mesh=mesh)
    want = oracle.collect_and_dedup(oracle.selected_stream(codes, k, w, h))
    np.testing.assert_array_equal(got, want)
    # superkmers: the window-index plane through the same empty shards
    gp, gi = shard.sharded_sketch(codes, k, w, h, mesh=mesh,
                                  mode="superkmers")
    wp, wi = oracle.collect_and_dedup_with_index(
        oracle.selected_stream(codes, k, w, h))
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gi, wi)


def test_seam_merge_with_trailing_skipped_run():
    """Device seams where the earlier side ends in SKIPPED windows: the
    naive last-output comparison would wrongly dedup; the ppermute seam
    carries the raw last window value and must match the oracle exactly."""
    from simd_minimizers_tpu.ops import pipeline
    from simd_minimizers_tpu.parallel import shard

    k, w = 5, 7
    l = k + w - 1
    rng = np.random.default_rng(7)
    for trial in range(8):
        n = 220
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        amb = np.zeros(n, np.uint8)
        # ambiguous chars clustered near the 2-shard boundary (window ~105)
        for p in rng.integers(90, 130, 3):
            amb[p] = 1
        h = NtHasher(k, canonical=True)
        mesh = shard.default_mesh(2)
        got = shard.sharded_sketch(codes, k, w, h, ambiguous_np=amb,
                                   mesh=mesh)
        sel = oracle.selected_stream(codes, k, w, h, ambiguous=amb)
        want = oracle.collect_and_dedup(sel, skip_sentinel=True)
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


def test_allgather_ragged_planes_lockstep(monkeypatch):
    """The stacked-plane ragged all-gather: one counts exchange + one
    buffer exchange serves N lockstep planes, and the unstacking
    reproduces each process's ragged arrays exactly. process_allgather
    is emulated for a 3-process world."""
    # per-process plane pairs with distinct ragged sizes (incl. empty)
    worlds = [
        (np.arange(5, dtype=np.uint32), np.arange(100, 105, dtype=np.uint32)),
        (np.zeros(0, np.uint32), np.zeros(0, np.uint32)),
        (np.arange(9, dtype=np.uint32), np.arange(200, 209, dtype=np.uint32)),
    ]
    nproc = len(worlds)
    calls = []

    def run_process(pid):
        def fake_allgather(x):
            # each process contributes its own x; all see the stacked result
            calls.append(x.shape)
            if x.dtype == np.int64:  # counts vector
                return np.stack([
                    np.asarray([worlds[p][plane_ix[0]].size], np.int64)
                    for p in range(nproc)
                ])
            cap = x.shape[-1]
            bufs = []
            for p in range(nproc):
                b = np.full_like(x, 0xFFFFFFFF)
                for i in range(x.shape[0]):
                    arr = worlds[p][i]
                    b[i, : arr.size] = arr
                bufs.append(b)
            return np.stack(bufs)

        plane_ix = [0]
        import jax.experimental.multihost_utils as mhu

        monkeypatch.setattr(mhu, "process_allgather", fake_allgather)
        planes = [worlds[pid][0], worlds[pid][1]]
        return multihost._allgather_ragged_planes(planes, nproc)

    for pid in range(nproc):
        calls.clear()
        parts, aux = run_process(pid)
        # exactly two collectives: one counts, one stacked buffer
        assert len(calls) == 2, calls
        assert calls[1][0] == 2  # both planes rode one exchange
        for p in range(nproc):
            np.testing.assert_array_equal(parts[p], worlds[p][0])
            np.testing.assert_array_equal(aux[p], worlds[p][1])

    # planes of unequal size must be rejected (lockstep contract)
    with pytest.raises(AssertionError):
        multihost._allgather_ragged_planes(
            [np.zeros(3, np.uint32), np.zeros(4, np.uint32)], 1)


def test_sharded_large_w_on_mesh():
    """Large w (l - 1 longer than a lane row) on the sharded path: 8-dev
    CPU mesh vs the oracle."""
    from simd_minimizers_tpu.parallel import shard

    k, w = 5, 1200
    n = 60000
    codes = RNG.integers(0, 4, n, dtype=np.uint8)
    h = NtHasher(k, canonical=False)
    mesh = shard.default_mesh()
    got = shard.sharded_sketch(codes, k, w, h, mesh=mesh)
    sel = oracle.selected_stream(codes, k, w, h)
    np.testing.assert_array_equal(got, oracle.collect_and_dedup(sel))
