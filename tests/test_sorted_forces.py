"""The sharded engine's force path on one device: `mtp_energy_forces` over
a bin-sorted list (SortedNeighborList) with the mirror give-back.

The sharded engine evaluates forces in sorted space on each shard's
halo-extended set and masks ghost rows as centers. These tests pin that
path against the user-order evaluation and the f64 loop-level oracle
(`utils/golden.py`), and pin the ghost semantics: a row masked as a center
still collects -T from every valid pair that points at it, so its force is
-dE_valid/dx for E_valid the sum of the valid centers' site energies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mtp_jax.io.basis_gen import make_mtp
from mtp_jax.md.simulation import make_lattice
from mtp_jax.models.mtp import (
    MTPModel,
    _gather_rows3,
    _gather_scalar,
    gather_displacements,
    mtp_energy_forces,
)
from mtp_jax.ops.moments import site_energies
from mtp_jax.ops.neighbors import (
    build_neighbor_list,
    build_sorted_neighbor_list,
    grid_shape,
)
from mtp_jax.utils import golden


def _system(species, seed=0):
    m = make_mtp(8, species_count=species, seed=0)
    kw = {"type_pattern": (0, 1)} if species == 2 else {}
    pos, types, cell = make_lattice("fcc", 4.0, (4, 4, 4), **kw)
    rng = np.random.default_rng(seed)
    pos = pos + rng.normal(0.0, 0.06, pos.shape)
    return m, pos, types, cell


def _sorted_eval(model, pos, types, cell, center_ok=None, compute_virial=True):
    """Sorted-space evaluation as the sharded engine runs it; forces and
    site energies are returned in user order."""
    p, cj = jnp.asarray(pos), jnp.asarray(cell)
    swl = build_sorted_neighbor_list(
        p, cj, model.cutoff, max_neighbors=64,
        grid=grid_shape(cell, model.cutoff),
    )
    assert not bool(swl.overflow)
    t_s = _gather_scalar(jnp.asarray(types, jnp.int32), swl.order)
    rows = jnp.arange(len(pos), dtype=swl.idx.dtype)
    pair_valid = swl.idx != rows[:, None]
    if center_ok is not None:
        pair_valid = pair_valid & jnp.asarray(center_ok)[swl.order][:, None]
    out = mtp_energy_forces(
        model.schedule, model.coeffs, _gather_rows3(p, swl.order), t_s,
        swl.idx, cj, swl.mirror,
        jtypes=_gather_scalar(t_s, swl.idx), pair_valid=pair_valid,
        compute_virial=compute_virial,
    )
    return dict(
        forces=np.asarray(_gather_rows3(out["forces"], swl.inv_order)),
        site_energies=np.asarray(out["site_energies"])[
            np.asarray(swl.inv_order)
        ],
        energy=float(out["energy"]),
        virial=np.asarray(out["virial"]),
    )


@pytest.mark.parametrize("compute_virial", [True, False])
@pytest.mark.parametrize("species", [1, 2])
def test_sorted_path_matches_user_order_and_oracle(species, compute_virial):
    m, pos, types, cell = _system(species)
    model = MTPModel.from_data(m, dtype=jnp.float64)
    out = _sorted_eval(model, pos, types, cell, compute_virial=compute_virial)

    p, cj = jnp.asarray(pos), jnp.asarray(cell)
    nl = build_neighbor_list(
        p, cj, model.cutoff, max_neighbors=64,
        grid=grid_shape(cell, model.cutoff), with_reverse=True,
    )
    ref = mtp_energy_forces(
        model.schedule, model.coeffs, p, jnp.asarray(types, jnp.int32),
        nl.idx, cj, nl.mirror, compute_virial=compute_virial,
    )
    np.testing.assert_allclose(out["forces"], np.asarray(ref["forces"]),
                               atol=1e-12)
    assert out["energy"] == pytest.approx(float(ref["energy"]), abs=1e-10)

    g = golden.compute(m, pos, types, cell=cell)
    n = len(pos)
    assert out["energy"] / n == pytest.approx(g["energy"] / n, abs=1e-12)
    np.testing.assert_allclose(out["forces"], g["forces"], atol=1e-10)
    if compute_virial:
        np.testing.assert_allclose(out["virial"], g["virial"], atol=1e-9)
    else:
        np.testing.assert_array_equal(out["virial"], 0.0)


@pytest.mark.parametrize("species", [1, 2])
def test_masked_centers_receive_giveback(species):
    """Rows masked as centers (a shard's ghosts) get -dE_valid/dx, the
    give-back of the valid centers' pairs, and contribute no energy."""
    m, pos, types, cell = _system(species, seed=1)
    model = MTPModel.from_data(m, dtype=jnp.float64)
    valid = pos[:, 0] < 0.5 * cell[0, 0]  # one half of the box are "owners"
    out = _sorted_eval(model, pos, types, cell, center_ok=valid)

    nl = build_neighbor_list(
        jnp.asarray(pos), jnp.asarray(cell), model.cutoff, max_neighbors=64,
        grid=grid_shape(cell, model.cutoff),
    )
    n = len(pos)
    t = jnp.asarray(types, jnp.int32)
    inv_cell = jnp.linalg.inv(jnp.asarray(cell))
    self_pair = nl.idx == jnp.arange(n)[:, None]

    def e_valid(p):
        disp = gather_displacements(p, nl.idx, jnp.asarray(cell), inv_cell)
        d2 = jnp.sum(disp * disp, axis=-1)
        mask = (d2 <= model.cutoff**2) & ~self_pair
        se = site_energies(model.schedule, model.coeffs, disp, mask, t,
                           t[nl.idx])
        return jnp.sum(jnp.where(jnp.asarray(valid), se, 0.0))

    f_ref = -np.asarray(jax.grad(e_valid)(jnp.asarray(pos)))
    np.testing.assert_allclose(out["forces"], f_ref, atol=1e-10)
    assert np.abs(out["forces"][~valid]).max() > 1e-3  # ghosts do collect
    e_sites = np.where(valid, out["site_energies"], 0.0).sum()
    assert e_sites == pytest.approx(float(e_valid(jnp.asarray(pos))),
                                    abs=1e-10)
