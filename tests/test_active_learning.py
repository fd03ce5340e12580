"""Active-learning tests: candidate-vector parity with the golden engine,
grade modes, MaxVol builder, .cfg I/O, and the two-threshold MD driver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mtp_jax.al.driver import (
    BreakThresholdExceeded,
    ExtrapolationMonitor,
    run_with_extrapolation,
)
from mtp_jax.al.grades import candidate_vectors, cfg_grade, nbh_grades
from mtp_jax.al.maxvol import build_mvs, maxvol_select
from mtp_jax.io.cfg_file import format_cfg, parse_cfgs, read_cfgs
from mtp_jax.io.mtp_file import MVSData, dumps_mtp, loads_mtp
from mtp_jax.md.simulation import Simulation, make_lattice
from mtp_jax.md.state import init_state, thermalize
from mtp_jax.models.mtp import MTPModel
from mtp_jax.ops.neighbors import build_neighbor_list_bruteforce
from mtp_jax.utils import golden

from conftest import scatter_cluster


def _nbrs(pos, cutoff, max_n=24, cell=None):
    nl = build_neighbor_list_bruteforce(
        jnp.asarray(pos), None if cell is None else jnp.asarray(cell), cutoff,
        max_neighbors=max_n,
    )
    assert not bool(nl.overflow)
    return nl.idx


@pytest.mark.parametrize("fixture", ["mtp_level8", "mtp_level8_2spec"])
def test_candidate_vector_parity(fixture, rng, request):
    m = request.getfixturevalue(fixture)
    n = 10
    pos = scatter_cluster(n, rng)
    types = rng.integers(0, m.species_count, n)
    g = golden.compute(m, pos, types, compute_grades=True)

    model = MTPModel.from_data(m, dtype=jnp.float64)
    b, site_e = candidate_vectors(
        model.schedule,
        model.coeffs,
        jnp.asarray(pos),
        jnp.asarray(types, jnp.int32),
        _nbrs(pos, m.max_dist),
    )
    np.testing.assert_allclose(
        np.asarray(b), g["energy_ders_wrt_coeffs"], atol=1e-11
    )
    assert abs(float(site_e) - g["energy"]) < 1e-10


def test_grades_parity(mtp_level8_2spec, rng):
    m = mtp_level8_2spec
    P = m.coeff_count
    A = rng.normal(size=(P, P)) + np.eye(P)
    m.mvs = MVSData(0, 0, 0, 1, 2.0, A, np.linalg.inv(A))
    try:
        n = 12
        pos = scatter_cluster(n, rng)
        types = rng.integers(0, 2, n)
        g = golden.compute(m, pos, types, compute_grades=True)

        model = MTPModel.from_data(m, dtype=jnp.float64)
        b, _ = candidate_vectors(
            model.schedule,
            model.coeffs,
            jnp.asarray(pos),
            jnp.asarray(types, jnp.int32),
            _nbrs(pos, m.max_dist),
        )
        grades = nbh_grades(b, model.inverse_active_set)
        np.testing.assert_allclose(np.asarray(grades), g["nbh_grades"], rtol=1e-9)

        # configuration-mode grade on the same data
        gc = cfg_grade(b, model.inverse_active_set, n)
        bsum = g["energy_ders_wrt_coeffs"].sum(axis=0)
        expect = np.abs(np.linalg.inv(A) @ bsum).max() / n
        np.testing.assert_allclose(float(gc), expect, rtol=1e-9)
    finally:
        m.mvs = None


def test_maxvol_select(rng):
    pool = rng.normal(size=(200, 12))
    idx, A = maxvol_select(pool)
    assert len(set(idx.tolist())) == 12
    C = pool @ np.linalg.inv(A)
    assert np.abs(C).max() <= 1.01 + 1e-9  # MaxVol dominance property


def test_build_mvs_roundtrip(mtp_level8, rng):
    m = mtp_level8
    P = m.coeff_count
    pool = rng.normal(size=(5 * P, P))
    m.mvs = build_mvs(pool, mode="neighborhood")
    try:
        m2 = loads_mtp(dumps_mtp(m))
        assert not m2.mvs.configuration_mode
        np.testing.assert_allclose(m2.mvs.active_set, m.mvs.active_set)
    finally:
        m.mvs = None


def test_cfg_roundtrip(rng):
    cell = np.diag([10.0, 11.0, 12.0])
    pos = rng.uniform(0, 10, (5, 3))
    types = np.array([0, 1, 0, 1, 0])
    grades = rng.uniform(0, 2, 5)
    txt = format_cfg(cell, pos, types, grades=grades, max_grade=float(grades.max()))
    txt += format_cfg(cell, pos, types, energy=-12.5)
    cfgs = parse_cfgs(txt)
    assert len(cfgs) == 2
    np.testing.assert_allclose(cfgs[0].cell, cell)
    np.testing.assert_allclose(cfgs[0].positions, pos, atol=1e-6)
    np.testing.assert_array_equal(cfgs[0].types, types)
    np.testing.assert_allclose(cfgs[0].grades, grades, atol=1e-5)
    assert cfgs[0].features["MV_grade"] == pytest.approx(grades.max(), abs=1e-6)
    assert cfgs[1].energy == pytest.approx(-12.5)
    assert cfgs[1].grades is None


def _al_system(m, rng, n_rep=2):
    model = MTPModel.from_data(m, dtype=jnp.float64)
    pos, types, cell = make_lattice("fcc", 4.0, (3, 3, 3))
    masses = np.full(len(pos), 58.693)
    state = init_state(pos, types, masses, cell, dtype=jnp.float64)
    return model, thermalize(jax.random.PRNGKey(5), state, 300.0)


def _with_realistic_mvs(m, rng, mode="neighborhood"):
    """Build an MVS state from candidate vectors of perturbed lattices so
    grades near the training manifold are ~1."""
    model = MTPModel.from_data(m, dtype=jnp.float64)
    pos, types, cell = make_lattice("fcc", 4.0, (2, 2, 2))
    rows = []
    for k in range(6):
        p = pos + rng.normal(scale=0.05 * (k + 1), size=pos.shape)
        b, _ = candidate_vectors(
            model.schedule,
            model.coeffs,
            jnp.asarray(p),
            jnp.asarray(types, jnp.int32),
            _nbrs(p, m.max_dist, max_n=48, cell=cell),
            jnp.asarray(cell),
        )
        rows.append(np.asarray(b))
    pool = np.concatenate(rows, axis=0)
    m.mvs = build_mvs(pool, mode=mode)
    return m


def test_evaluate_reuses_supplied_neighbor_list(mtp_level8, rng):
    """Grades from a caller-supplied Verlet list (built at cutoff+skin)
    must equal a fresh-rebuild evaluation: no per-eval rebuild."""
    from mtp_jax.ops.neighbors import build_neighbor_list, grid_shape

    m = _with_realistic_mvs(mtp_level8, rng)
    try:
        model = MTPModel.from_data(m, dtype=jnp.float64)
        pos, types, cell = make_lattice("fcc", 4.0, (6, 6, 6))
        pos = pos + rng.normal(scale=0.06, size=pos.shape)
        state = init_state(
            pos, types, np.full(len(pos), 58.7), cell, dtype=jnp.float64
        )
        mon = ExtrapolationMonitor(model, max_neighbors=64)
        g_fresh = mon.evaluate(state)
        grades_fresh = mon.nbh_grades.copy()

        skin = 0.6
        grid = grid_shape(cell, model.cutoff + skin)
        nl = build_neighbor_list(
            state.positions, state.cell, model.cutoff + skin,
            max_neighbors=64, grid=grid, with_reverse=True,
        )
        g_nl, st2 = mon.evaluate(state, nl=nl, refresh_forces=True)
        assert g_nl == pytest.approx(g_fresh, rel=1e-10)
        np.testing.assert_allclose(mon.nbh_grades, grades_fresh, rtol=1e-9)

        # the refreshed state equals a fresh-rebuild refresh
        _, st_fresh = mon.evaluate(state, refresh_forces=True)
        np.testing.assert_allclose(
            np.asarray(st2.forces), np.asarray(st_fresh.forces), atol=1e-10
        )
        assert float(st2.potential_energy) == pytest.approx(
            float(st_fresh.potential_energy), abs=1e-9
        )
    finally:
        m.mvs = None


def test_monitor_requires_mvs(mtp_level8):
    model = MTPModel.from_data(mtp_level8, dtype=jnp.float64)
    with pytest.raises(ValueError):
        ExtrapolationMonitor(model)


def test_extrapolation_md_select_and_break(mtp_level8, rng, tmp_path):
    m = _with_realistic_mvs(mtp_level8, rng)
    try:
        model = MTPModel.from_data(m, dtype=jnp.float64)
        _, state = _al_system(m, rng)
        sim = Simulation(model, max_neighbors=48, skin=0.6, steps_per_rebuild=5)
        out = tmp_path / "preselected.cfg"
        mon = ExtrapolationMonitor(
            model,
            select_threshold=0.0,  # select every evaluation
            break_threshold=1e9,
            output_path=str(out),
            max_neighbors=48,
        )
        state = run_with_extrapolation(
            sim, mon, state, 10, al_every=5, ensemble="nve", dt=0.001
        )
        assert mon.max_grade > 0
        assert mon.nbh_grades is not None and len(mon.nbh_grades) == state.n_atoms
        mon.close()
        cfgs = read_cfgs(str(out))
        assert len(cfgs) == 3  # initial + 2 evaluations
        assert cfgs[0].grades is not None
        assert "MV_grade" in cfgs[0].features

        # break threshold: everything written before the raise must be on disk
        mon2 = ExtrapolationMonitor(
            model,
            select_threshold=0.0,
            break_threshold=0.0,  # break immediately
            output_path=str(tmp_path / "break.cfg"),
            max_neighbors=48,
        )
        with pytest.raises(BreakThresholdExceeded):
            run_with_extrapolation(
                sim, mon2, state, 10, al_every=5, ensemble="nve", dt=0.001
            )
        assert len(read_cfgs(str(tmp_path / "break.cfg"))) == 1  # flushed
    finally:
        m.mvs = None


def test_configuration_mode_monitor(mtp_level8, rng, tmp_path):
    m = _with_realistic_mvs(mtp_level8, rng, mode="configuration")
    try:
        model = MTPModel.from_data(m, dtype=jnp.float64)
        assert model.configuration_mode
        _, state = _al_system(m, rng)
        mon = ExtrapolationMonitor(model, max_neighbors=48)
        g = mon.evaluate(state)
        assert np.isfinite(g) and g >= 0
        assert mon.nbh_grades is None  # per-atom grades unavailable in cfg mode
    finally:
        m.mvs = None


def test_monitor_regrows_on_neighbor_overflow(mtp_level8, rng):
    """A dense configuration must not silently truncate neighborhoods: the
    monitor regrows max_neighbors until the build fits (round-1 ADVICE hole:
    truncated lists UNDERESTIMATE grades)."""
    m = _with_realistic_mvs(mtp_level8, rng)
    try:
        model = MTPModel.from_data(m, dtype=jnp.float64)
        _, state = _al_system(m, rng)
        mon_small = ExtrapolationMonitor(model, max_neighbors=4)
        g_small = mon_small.evaluate(state)
        assert mon_small.max_neighbors > 4  # regrew
        mon_big = ExtrapolationMonitor(model, max_neighbors=64)
        g_big = mon_big.evaluate(state)
        assert g_small == pytest.approx(g_big, rel=1e-9)
    finally:
        m.mvs = None


def test_candidates_and_forces_fused_parity(mtp_level8, rng):
    """The fused grade-step evaluation must match the separate candidate and
    force paths exactly (shared-forward fusion, VERDICT round-1 item 6)."""
    from mtp_jax.al.grades import candidates_and_forces
    from mtp_jax.models.mtp import mtp_energy_forces
    from mtp_jax.ops.neighbors import build_neighbor_list_bruteforce

    m = mtp_level8
    model = MTPModel.from_data(m, dtype=jnp.float64)
    pos, types, cell = make_lattice("fcc", 4.0, (2, 2, 2))
    pos = pos + rng.normal(scale=0.05, size=pos.shape)
    nl = build_neighbor_list_bruteforce(
        jnp.asarray(pos), jnp.asarray(cell), model.cutoff, max_neighbors=48
    )
    t = jnp.asarray(types, jnp.int32)
    fused = candidates_and_forces(
        model.schedule, model.coeffs, jnp.asarray(pos), t, nl.idx, jnp.asarray(cell)
    )
    b_ref, se_ref = candidate_vectors(
        model.schedule, model.coeffs, jnp.asarray(pos), t, nl.idx, jnp.asarray(cell)
    )
    f_ref = mtp_energy_forces(
        model.schedule, model.coeffs, jnp.asarray(pos), t, nl.idx, jnp.asarray(cell)
    )
    np.testing.assert_allclose(np.asarray(fused["b"]), np.asarray(b_ref), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(fused["forces"]), np.asarray(f_ref["forces"]), atol=1e-12
    )
    assert float(fused["energy"]) == pytest.approx(float(f_ref["energy"]), abs=1e-10)


@pytest.mark.parametrize("species", [1, 2])
def test_candidates_sorted_list_parity(rng, species):
    """The sharded engine's grade path: `candidates_and_forces` over a
    bin-sorted list (SortedNeighborList, mirror give-back) equals the plain
    user-order evaluation, and masking rows as centers (`row_valid`, the
    ghost rows of a shard) zeroes exactly their energy and candidate rows."""
    from mtp_jax.al.grades import candidates_and_forces
    from mtp_jax.io.basis_gen import make_mtp
    from mtp_jax.models.mtp import _gather_rows3, _gather_scalar
    from mtp_jax.ops.neighbors import (
        build_neighbor_list,
        build_sorted_neighbor_list,
        grid_shape,
    )

    m = make_mtp(8, species_count=species, seed=0)
    model = MTPModel.from_data(m, dtype=jnp.float64)
    kw = {"type_pattern": (0, 1)} if species == 2 else {}
    pos, types, cell = make_lattice("fcc", 4.0, (4, 4, 4), **kw)
    p = jnp.asarray(pos + rng.normal(0, 0.06, pos.shape))
    cj = jnp.asarray(cell)
    tj = jnp.asarray(types, jnp.int32)
    grid = grid_shape(cell, model.cutoff)
    nl = build_neighbor_list(
        p, cj, model.cutoff, max_neighbors=64, grid=grid, with_reverse=True
    )
    ref = candidates_and_forces(
        model.schedule, model.coeffs, p, tj, nl.idx, cj, nl.mirror
    )
    swl = build_sorted_neighbor_list(
        p, cj, model.cutoff, max_neighbors=64, grid=grid
    )
    assert not bool(swl.overflow)
    p_s = _gather_rows3(p, swl.order)
    t_s = _gather_scalar(tj, swl.order)
    out = candidates_and_forces(
        model.schedule, model.coeffs, p_s, t_s, swl.idx, cj, swl.mirror
    )
    np.testing.assert_allclose(
        np.asarray(_gather_rows3(out["forces"], swl.inv_order)),
        np.asarray(ref["forces"]), atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(out["b"])[np.asarray(swl.inv_order)],
        np.asarray(ref["b"]), atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(out["virial"]), np.asarray(ref["virial"]), atol=1e-10
    )

    valid = np.arange(len(pos)) % 3 != 0
    masked = candidates_and_forces(
        model.schedule, model.coeffs, p_s, t_s, swl.idx, cj, swl.mirror,
        row_valid=jnp.asarray(valid),
    )
    se = np.asarray(out["site_energies"])
    assert float(masked["energy"]) == pytest.approx(
        float(se[valid].sum()), abs=1e-10
    )
    b_m = np.asarray(masked["b"])
    np.testing.assert_array_equal(b_m[~valid], 0.0)
    np.testing.assert_allclose(b_m[valid], np.asarray(out["b"])[valid], atol=1e-12)


def test_extrapolation_md_npt_trajectory(mtp_level8, rng):
    """AL under a barostat (the reference runs `fix npt` + `fix pair ...
    extrapolation`): the grade pass now tallies the virial alongside
    forces/energy, so the refreshed state is fully consistent and the AL
    run must reproduce the plain NPT trajectory exactly."""
    m = _with_realistic_mvs(mtp_level8, rng)
    try:
        model = MTPModel.from_data(m, dtype=jnp.float64)
        _, state0 = _al_system(m, rng)
        kw = dict(ensemble="npt", dt=0.001, temperature=300.0,
                  pressure=0.0, tdamp=0.05, pdamp=0.5)

        sim_ref = Simulation(model, max_neighbors=48, skin=0.6,
                             steps_per_rebuild=5, compute_virial=True)
        ref, _ = sim_ref.run(state0, 10, **kw)

        sim = Simulation(model, max_neighbors=48, skin=0.6,
                         steps_per_rebuild=5, compute_virial=True)
        mon = ExtrapolationMonitor(model, max_neighbors=48)
        state = run_with_extrapolation(sim, mon, state0, 10, al_every=5, **kw)
        assert mon.max_grade > 0
        np.testing.assert_allclose(
            np.asarray(state.positions), np.asarray(ref.positions), atol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(state.cell), np.asarray(ref.cell), atol=1e-10
        )
    finally:
        m.mvs = None


def test_candidates_chunked_rows_match(monkeypatch, rng):
    """Above CHUNK_ROWS rows the grade-step evaluation runs chunk by chunk
    (bounded (rows, J, B) tables); the result equals the one-pass result,
    ghost-style masked rows included."""
    from mtp_jax.al import grades
    from mtp_jax.io.basis_gen import make_mtp
    from mtp_jax.ops.neighbors import build_neighbor_list, grid_shape

    m = make_mtp(8, species_count=2, seed=0)
    model = MTPModel.from_data(m, dtype=jnp.float64)
    pos, types, cell = make_lattice("fcc", 4.0, (4, 4, 4), type_pattern=(0, 1))
    p = jnp.asarray(pos + rng.normal(0, 0.05, pos.shape))
    c, t = jnp.asarray(cell), jnp.asarray(types, jnp.int32)
    nl = build_neighbor_list(
        p, c, model.cutoff, max_neighbors=64,
        grid=grid_shape(cell, model.cutoff), with_reverse=True,
    )
    rv = jnp.asarray(np.arange(len(pos)) % 3 != 0)
    args = (model.schedule, model.coeffs, p, t, nl.idx, c, nl.mirror)
    one = grades.candidates_and_forces(*args, row_valid=rv)
    monkeypatch.setattr(grades, "CHUNK_ROWS", 100)  # 256 rows -> 3 chunks
    jax.clear_caches()
    chunked = grades.candidates_and_forces(*args, row_valid=rv)
    for k in ("b", "site_energies", "forces", "virial"):
        np.testing.assert_allclose(
            np.asarray(chunked[k]), np.asarray(one[k]), atol=1e-12
        )
