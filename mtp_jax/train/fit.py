"""MTP coefficient fitting (training) on energy/force data.

The reference consumes potentials trained by MLIP-3; with this module the
framework is self-contained: read a ``.cfg`` training set (or any arrays),
fit the MTP coefficients, write a ``.mtp`` — then run MD and active learning
on it, and retrain on the selected configurations.

Accelerator-shaped: configurations are padded to a common atom count and batched;
the loss vmaps the energy model over the batch, forces come from autodiff
(second-order AD through the XLA path for the force loss), and the optimizer
is optax Adam with a linear-least-squares warm start for the coefficients the
energy is linear in (species constants + basis weights).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mtp_jax.io.cfg_file import Config
from mtp_jax.models.mtp import MTPCoeffs, gather_displacements
from mtp_jax.ops.moments import MTPSchedule, site_energies
from mtp_jax.utils.native import cell_list_host


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Dataset:
    """Padded, batched training data (C configurations, N_max atoms each)."""

    positions: jax.Array  # (C, N, 3)
    types: jax.Array  # (C, N) int32
    real: jax.Array  # (C, N) bool
    nbr_idx: jax.Array  # (C, N, J) int32 (self-padded)
    cells: jax.Array  # (C, 3, 3)
    energies: jax.Array  # (C,)
    forces: jax.Array  # (C, N, 3)
    has_forces: jax.Array  # (C,) bool

    @property
    def n_configs(self):
        return self.positions.shape[0]


def make_dataset(
    configs: Sequence[Config],
    cutoff: float,
    *,
    max_neighbors: int = 64,
    dtype=jnp.float64,
) -> Dataset:
    """Build a padded dataset from parsed .cfg configurations (host side)."""
    n_max = max(len(c.positions) for c in configs)
    C = len(configs)
    pos = np.zeros((C, n_max, 3))
    typ = np.zeros((C, n_max), np.int32)
    real = np.zeros((C, n_max), bool)
    idx = np.tile(np.arange(n_max, dtype=np.int32)[None, :, None], (C, 1, max_neighbors))
    cells = np.zeros((C, 3, 3))
    es = np.zeros(C)
    fs = np.zeros((C, n_max, 3))
    hasf = np.zeros(C, bool)
    for k, c in enumerate(configs):
        n = len(c.positions)
        pos[k, :n] = c.positions
        typ[k, :n] = c.types
        real[k, :n] = True
        cells[k] = c.cell
        nbr, _, ovf = cell_list_host(c.positions, c.cell, cutoff, max_neighbors)
        if ovf:
            raise ValueError(f"config {k}: neighbor overflow at J={max_neighbors}")
        idx[k, :n] = nbr
        if c.energy is not None:
            es[k] = c.energy
        if c.forces is not None:
            fs[k, :n] = c.forces
            hasf[k] = True
    return Dataset(
        positions=jnp.asarray(pos, dtype),
        types=jnp.asarray(typ),
        real=jnp.asarray(real),
        nbr_idx=jnp.asarray(idx),
        cells=jnp.asarray(cells, dtype),
        energies=jnp.asarray(es, dtype),
        forces=jnp.asarray(fs, dtype),
        has_forces=jnp.asarray(hasf),
    )


def _config_energy(sched, coeffs, positions, types, real, nbr_idx, cell):
    """Total energy of one (padded) configuration; pad atoms contribute 0."""
    n = positions.shape[0]
    inv_cell = jnp.linalg.inv(cell)
    disp = gather_displacements(positions, nbr_idx, cell, inv_cell)
    d2 = jnp.sum(disp * disp, axis=-1)
    self_pair = nbr_idx == jnp.arange(n, dtype=nbr_idx.dtype)[:, None]
    mask = (
        (d2 <= sched.max_dist**2)
        & (~self_pair)
        & real[nbr_idx]
        & real[:, None]
    )
    e = site_energies(sched, coeffs, disp, mask, types, types[nbr_idx])
    return jnp.sum(jnp.where(real, e, 0.0))


def _basis_features(sched, coeffs, positions, types, real, nbr_idx, cell):
    """Per-config (sum of basis members, species counts): the design row for
    the linear warm start (E is linear in moment_coeffs and species_coeffs)."""
    from mtp_jax.ops.moments import basic_moments, contract_dag

    n = positions.shape[0]
    inv_cell = jnp.linalg.inv(cell)
    disp = gather_displacements(positions, nbr_idx, cell, inv_cell)
    d2 = jnp.sum(disp * disp, axis=-1)
    self_pair = nbr_idx == jnp.arange(n, dtype=nbr_idx.dtype)[:, None]
    mask = (d2 <= sched.max_dist**2) & (~self_pair) & real[nbr_idx] & real[:, None]
    mb, _ = basic_moments(sched, coeffs, disp, mask, types, types[nbr_idx])
    m = contract_dag(sched, mb)
    w = real.astype(m.dtype)
    basis = jnp.sum(m[:, sched.mapping] * w[:, None], axis=0)  # (n_scalar,)
    counts = jnp.sum(
        jax.nn.one_hot(types, sched.species_count, dtype=m.dtype) * w[:, None],
        axis=0,
    )
    return basis, counts


def linear_warm_start(sched: MTPSchedule, coeffs: MTPCoeffs, data: Dataset) -> MTPCoeffs:
    """Least-squares fit of (species_coeffs, moment_coeffs) on energies with
    the radial coefficients held fixed."""
    feats = jax.vmap(
        lambda p, t, r, i, c: _basis_features(sched, coeffs, p, t, r, i, c)
    )(data.positions, data.types, data.real, data.nbr_idx, data.cells)
    basis, counts = feats  # (C, n_scalar), (C, S)
    A = jnp.concatenate([counts, basis], axis=1)
    sol, *_ = jnp.linalg.lstsq(A, data.energies)
    S = sched.species_count
    return MTPCoeffs(
        radial_coeffs=coeffs.radial_coeffs,
        species_coeffs=sol[:S].astype(coeffs.species_coeffs.dtype),
        moment_coeffs=sol[S:].astype(coeffs.moment_coeffs.dtype),
    )


def loss_fn(
    sched: MTPSchedule,
    coeffs: MTPCoeffs,
    data: Dataset,
    *,
    energy_weight: float = 1.0,
    force_weight: float = 0.01,
):
    """Weighted energy + force MSE (per-atom-normalized energies)."""

    def e_of(pos, t, r, i, c):
        return _config_energy(sched, coeffs, pos, t, r, i, c)

    def one(pos, t, r, i, c, e_ref, f_ref, hasf):
        n_real = jnp.maximum(jnp.sum(r), 1)
        e, grad = jax.value_and_grad(e_of)(pos, t, r, i, c)
        de = (e - e_ref) / n_real
        le = de * de
        f_pred = -grad * r[:, None]
        lf = jnp.where(
            hasf, jnp.sum((f_pred - f_ref * r[:, None]) ** 2) / n_real, 0.0
        )
        return le, lf

    le, lf = jax.vmap(one)(
        data.positions,
        data.types,
        data.real,
        data.nbr_idx,
        data.cells,
        data.energies,
        data.forces,
        data.has_forces,
    )
    return energy_weight * jnp.mean(le) + force_weight * jnp.mean(lf)


def fit(
    sched: MTPSchedule,
    coeffs: MTPCoeffs,
    data: Dataset,
    *,
    steps: int = 300,
    learning_rate: float = 3e-3,
    energy_weight: float = 1.0,
    force_weight: float = 0.01,
    warm_start: bool = True,
    verbose_every: Optional[int] = None,
):
    """Fit all MTP coefficients with Adam (optional linear warm start).

    Returns (coeffs, losses)."""
    import optax

    if warm_start:
        coeffs = linear_warm_start(sched, coeffs, data)

    opt = optax.adam(learning_rate)
    opt_state = opt.init(coeffs)

    @partial(jax.jit, static_argnames=())
    def step(coeffs, opt_state):
        l, g = jax.value_and_grad(
            lambda c: loss_fn(
                sched, c, data,
                energy_weight=energy_weight, force_weight=force_weight,
            )
        )(coeffs)
        updates, opt_state = opt.update(g, opt_state)
        coeffs = optax.apply_updates(coeffs, updates)
        return coeffs, opt_state, l

    losses = []
    best = coeffs
    best_loss = float(
        loss_fn(sched, coeffs, data,
                energy_weight=energy_weight, force_weight=force_weight)
    )
    for k in range(steps):
        coeffs, opt_state, l = step(coeffs, opt_state)
        losses.append(float(l))
        if losses[-1] < best_loss:
            best_loss, best = losses[-1], coeffs
        if verbose_every and k % verbose_every == 0:
            print(f"step {k}: loss {losses[-1]:.3e}")
    return best, np.array(losses)
