"""chip_smoke.py's phases at a tiny size on the CPU, its refusal to run off
the GPU, and the compile-cache helper every entry point calls.

The phases run here with a level-8 potential on small boxes: this pins
their control flow and their comparisons, while the full-width run (level
16, 32k atoms; 1M atoms on four cards) happens on the card.
"""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import jax
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

TINY = cs.Size(reps=(4, 4, 4), golden_reps=(3, 3, 3), level=8, spb=10,
               blocks=2, eq_steps=20)


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_without_gpu(argv, capsys):
    assert cs.main(argv) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def test_force_parity_phase():
    ok, info = cs.phase_force_parity(TINY)
    assert ok, info
    assert list(info["fp32_vs_f64"]) == ["xla"]  # no GPU: no kernel
    assert info["fp32_vs_f64"]["xla"]["df_max"] <= cs.F_TOL
    assert info["f64_vs_golden"]["df_max"] <= cs.GOLDEN_F_TOL


def test_md_phase():
    ok, info = cs.phase_md(TINY)
    assert ok, info
    assert len(info["block_energies_ev_per_atom"]) == TINY.blocks + 1
    assert abs(info["nve_drift_ev_per_atom"]) < 1e-4


def test_active_learning_phase():
    ok, info = cs.phase_active_learning(TINY)
    assert ok, info
    assert info["max_grade_f64"] > 0


def test_exactness_phase():
    ok, info = cs.phase_exactness()
    assert ok, info


def test_sharded_phase_on_virtual_devices():
    """Slabs and 2x2 bricks on 4 virtual CPU devices against the
    single-device run. The CPU keeps no memory statistics, so the phase's
    overall verdict (which needs a peak on every device) is False here;
    every comparison it makes must hold."""
    size = cs.Size(reps=(12, 6, 3), golden_reps=(3, 3, 3), level=8, spb=10,
                   blocks=2)
    _, info = cs.phase_sharded(size, nd=4)
    for kind in ("slabs", "bricks"):
        r = info[kind]
        assert r["shards_on_every_device"]
        assert cs._within(r["step0_vs_single"], info["atoms"])
        assert r["grade_max_abs_err"] <= cs.GRADE_TOL * r[
            "grade_cancellation_scale"]
        assert abs(r["nve_drift_ev_per_atom"]
                   - info["single_nve_drift_ev_per_atom"]) < 1e-5
        json.dumps(r)  # the record the script prints


@pytest.mark.gpu
def test_smoke_phases_on_gpu(gpu):
    """The tiny phases on the card (the full-width run is chip_smoke.py)."""
    for ok, info in (cs.phase_force_parity(TINY), cs.phase_md(TINY),
                     cs.phase_exactness()):
        assert ok, info


# ------------------------------------------------------ compile cache


def _load_cache_module(path):
    spec = importlib.util.spec_from_file_location("cache_copy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    from mtp_jax.utils import cache

    monkeypatch.setenv(cache.ENV, str(tmp_path / "env_cache"))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == str(tmp_path / "env_cache")
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads env


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from mtp_jax.utils import cache

    monkeypatch.delenv(cache.ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_compile_cache() == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(ROOT / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_moves_with_checkout(monkeypatch, tmp_path):
    """A copied checkout keeps its cache inside itself."""
    from mtp_jax.utils import cache

    dst = tmp_path / "moved" / "mtp_jax" / "utils"
    dst.mkdir(parents=True)
    shutil.copy(cache.__file__, dst / "cache.py")
    moved = _load_cache_module(dst / "cache.py")
    monkeypatch.delenv(cache.ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert moved.enable_compile_cache() == str(
            (tmp_path / "moved" / ".jax_cache").resolve()
        )
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
