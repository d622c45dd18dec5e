"""Stream compaction (ops/pipeline.py) == NumPy boolean indexing.

compact_flat front-packs a whole (R, C) stream; compact_rows packs each
row on its own, either as several planes sharing one keep mask or as one
packed (shift << 16 | row-local value) plane; rows_to_flat concatenates
the packed rows on the host. Shapes cover one and many rows, densities
cover nothing, everything, the typical minimizer density and ragged
per-row densities.
"""

import numpy as np
import pytest

from simd_minimizers_tpu.ops import pipeline

SHAPES = [(1, 16), (4, 64), (8, 256)]
DENSITIES = [0.0, 0.17, 1.0, "ragged"]


def _case(R, C, density, seed):
    rng = np.random.default_rng(seed)
    if density == "ragged":
        p = np.linspace(0.0, 1.0, R)[:, None]  # row r keeps ~r/(R-1)
    else:
        p = np.full((R, 1), density)
    keep = rng.random((R, C)) < p
    rowbase = (np.arange(R, dtype=np.uint32) * C)[:, None]
    vals = (rowbase + rng.integers(0, C + 30, (R, C))).astype(np.uint32)
    return keep, vals, rowbase


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("R,C", SHAPES)
def test_compact_flat(R, C, density):
    import jax.numpy as jnp

    keep, vals, _ = _case(R, C, density, R * C)
    out, count = pipeline.compact_flat(jnp.asarray(vals.reshape(-1)),
                                       jnp.asarray(keep.reshape(-1)), R, C)
    out, count = np.asarray(out), int(count)
    want = vals[keep]
    assert count == want.size
    np.testing.assert_array_equal(out[:count], want)
    assert np.all(out[count:] == pipeline.INVALID_INT)


@pytest.mark.parametrize("packed", [False, True], ids=["planes", "packed"])
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("R,C", SHAPES)
def test_compact_rows_and_rows_to_flat(R, C, density, packed):
    import jax.numpy as jnp

    keep, vals, rowbase = _case(R, C, density, R * C + 1)
    rb = jnp.asarray(np.broadcast_to(rowbase, (R, C)))
    if packed:
        row_local = (lambda v: v - rb, lambda v: v + rb)
        planes, counts = pipeline.compact_rows([jnp.asarray(vals)],
                                               jnp.asarray(keep), row_local)
        want_planes = [vals]
    else:
        second = (vals ^ np.uint32(0x5A5A5A5A)).astype(np.uint32)
        planes, counts = pipeline.compact_rows(
            [jnp.asarray(vals), jnp.asarray(second)], jnp.asarray(keep))
        want_planes = [vals, second]
    counts = np.asarray(counts)
    np.testing.assert_array_equal(counts, keep.sum(axis=1))
    for got, want in zip(planes, want_planes):
        got = np.asarray(got)
        for r in range(R):
            np.testing.assert_array_equal(got[r, : counts[r]], want[r][keep[r]])
        np.testing.assert_array_equal(pipeline.rows_to_flat(got, counts),
                                      want[keep])
