"""Tests for the MTP basis (alpha table) generator."""

import numpy as np
import pytest

from mtp_jax.io.basis_gen import generate_basis, make_mtp
from mtp_jax.utils import golden


@pytest.mark.parametrize("level", [6, 8, 12])
def test_tables_well_formed(level):
    b = generate_basis(level)
    basic = b["alpha_index_basic"]
    times = b["alpha_index_times"]
    mapping = b["alpha_moment_mapping"]
    M = b["alpha_moments_count"]
    B = len(basic)
    assert basic[:, 0].max() == b["radial_funcs_count"] - 1
    assert (basic[:, 1:] >= 0).all()
    # rows reference already-computed nodes only (topological by child)
    assert (times[:, 0] < times[:, 3]).all()
    assert (times[:, 1] < times[:, 3]).all()
    assert (times[:, 3] >= B).all()
    assert times[:, 3].max() < M if len(times) else True
    assert (np.diff(times[:, 3]) >= 0).all()  # sorted by child
    assert mapping.max() < M
    assert len(set(mapping.tolist())) == len(mapping)


def test_rotation_invariance():
    """Energy must be invariant under global rotation of the neighborhood."""
    m = make_mtp(10, species_count=1, seed=7)
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 4.0, (8, 3))
    pos[1:] = pos[0] + (pos[1:] - pos[0]) * 2.0  # spread out
    types = np.zeros(8, dtype=int)
    e0 = golden.compute(m, pos, types)["energy"]
    # random rotation via QR
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    e1 = golden.compute(m, pos @ q.T, types)["energy"]
    assert abs(e0 - e1) < 1e-10 * max(1.0, abs(e0))


def test_permutation_invariance():
    m = make_mtp(8, species_count=1, seed=2)
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 5.0, (7, 3)) * 1.4
    types = np.zeros(7, dtype=int)
    e0 = golden.compute(m, pos, types)["energy"]
    perm = rng.permutation(7)
    e1 = golden.compute(m, pos[perm], types[perm])["energy"]
    assert abs(e0 - e1) < 1e-10 * max(1.0, abs(e0))


def test_basis_linearly_independent():
    """Selected scalar basis functions are linearly independent on random
    realizable neighborhoods (evaluated through the emitted DAG)."""
    m = make_mtp(10, species_count=1, seed=5)
    rng = np.random.default_rng(3)
    n_samples = 4 * len(m.alpha_moment_mapping)
    rows = []
    for s in range(n_samples):
        pos = np.vstack([[0, 0, 0], rng.uniform(-3, 3, (9, 3))])
        keep = np.linalg.norm(pos[1:], axis=1) > 1.2
        pos = np.vstack([pos[:1], pos[1:][keep]])
        types = np.zeros(len(pos), dtype=int)
        out = golden.compute(m, pos, types, compute_grades=True)
        off = m.radial_coeff_count + m.species_count
        rows.append(out["energy_ders_wrt_coeffs"][0, off:])  # basis members
    V = np.array(rows)
    s = np.linalg.svd(V, compute_uv=False)
    assert s[-1] > 1e-9 * s[0], f"dependent basis: sv ratio {s[-1]/s[0]:.2e}"


def test_wave_count_small():
    """Generated DAGs stay shallow (the reference's block engine requires <=3
    waves for MLIP templates; ours should match for star+product bases)."""
    from mtp_jax.ops.moments import MTPSchedule

    for level in (8, 12):
        b = generate_basis(level)
        sched = MTPSchedule.from_tables(
            species_count=1,
            radial_basis_size=8,
            radial_funcs_count=b["radial_funcs_count"],
            min_dist=1.5,
            max_dist=5.0,
            scaling=1.0,
            alpha_moments_count=b["alpha_moments_count"],
            alpha_index_basic=b["alpha_index_basic"],
            alpha_index_times=b["alpha_index_times"],
            alpha_moment_mapping=b["alpha_moment_mapping"],
        )
        assert len(sched.waves()) <= 4
