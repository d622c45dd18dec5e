"""chip_smoke.py and bench.py on the CPU: they refuse to run without a GPU,
their comparison machinery is exact, and every smoke phase runs end to
end at a tiny size. Also: where the compile cache goes."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from simd_minimizers_tpu.hashers import NtHasher  # noqa: E402
from simd_minimizers_tpu.ops import oracle  # noqa: E402

TINY = dict(main_bp=20000, modes_bp=30000, reads=3000, read_bp=150,
            read_sample=300, w2047_bp=30000, w32767_bp=70000,
            short_seqs=30, short_max_bp=8192, per_card_bp=20000)


def _run(args, cwd=REPO, **env):
    e = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_cpu(script):
    res = _run([os.path.join(REPO, script)])
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "{" not in res.stdout, "printed a result without a GPU"


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot run."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=dict(os.environ, JAX_PLATFORMS="cpu",
                                  PYTHONPATH=""),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and '"ok": true' not in res.stdout


CACHE_PROBE = ("import jax{first}; import simd_minimizers_tpu.ops.pipeline; "
               "print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("env_dir,jax_first", [
    (None, False), (None, True), ("custom", False)])
def test_compile_cache_placement(tmp_path, env_dir, jax_first):
    """$JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache —
    also when JAX was imported before the package."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = CACHE_PROBE.format(first="; jax.devices()" if jax_first else "")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == want


@pytest.mark.parametrize("mode,amb_rate", [
    ("minimizers", 0), ("superkmers", 0), ("closed_syncmers", 0),
    ("open_syncmers", 0), ("minimizers", 0.002)])
def test_blocked_oracle_matches_whole(mode, amb_rate):
    """The smoke test's oracle, computed in blocks with the seam window
    carried, equals the oracle over the whole sequence."""
    rng = np.random.default_rng(7)
    k, w = 11, 7
    codes = rng.integers(0, 4, 70000, dtype=np.uint8)
    amb = None
    if amb_rate:
        amb = (rng.random(codes.size) < amb_rate).astype(np.uint8)
        amb[16380:16400] = 1  # a run across the first block seam
    h = NtHasher(k, canonical=not mode.endswith("syncmers"))
    sel = oracle.selected_stream(codes, k, w, h, ambiguous=amb)
    if mode == "superkmers":
        want = oracle.collect_and_dedup_with_index(sel)
    elif mode.endswith("syncmers"):
        want = (oracle.collect_syncmers(sel, w, mode == "open_syncmers"),)
    else:
        want = (oracle.collect_and_dedup(sel, skip_sentinel=amb is not None),)
    got = chip_smoke.oracle_sketch(codes, k, w, h, mode, amb)
    chip_smoke.expect_equal(mode, got, want)


def test_blocked_oracle_on_worker_pool():
    import multiprocessing

    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, 50000, dtype=np.uint8)
    h = NtHasher(21, canonical=True)
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        got = chip_smoke.oracle_sketch(codes, 21, 11, h, pool=pool)
    want = oracle.collect_and_dedup(oracle.selected_stream(codes, 21, 11, h))
    chip_smoke.expect_equal("pool", got, (want,))
    with pytest.raises(AssertionError, match="first difference at index 3"):
        bad = want.copy()
        bad[3] += 1
        chip_smoke.expect_equal("pool", got, (bad,))


@pytest.mark.parametrize("mode", ["minimizers", "superkmers",
                                  "closed_syncmers", "open_syncmers"])
def test_no_float_dot(mode):
    """The streaming chunk program is integer-only: no dot to run in TF32."""
    chip_smoke.no_float_dot(21, 11, NtHasher(21, canonical=True), mode)


@pytest.mark.parametrize("names", ["bc", "d", "e", "f", "g"])
def test_smoke_phases_tiny(names, monkeypatch):
    """Each default phase end to end at a tiny size on the CPU (the chunk
    and batch thresholds shrunk so the same routes are taken)."""
    from simd_minimizers_tpu.ops import backend

    monkeypatch.setattr(backend, "PIPELINE_CHUNK_WINDOWS", 4096)
    monkeypatch.setattr(backend, "RECORDS_BATCH_MAX_BP", 5000)
    phases = [p for p in chip_smoke.PHASES if p[0] in names]
    assert chip_smoke.run_phases(phases, TINY, None) == []


def test_four_card_phase_tiny():
    """The --four-cards phase on four of the eight virtual CPU devices."""
    assert chip_smoke.run_phases([("four-cards", chip_smoke.phase_four_cards)],
                                 TINY, None) == []
