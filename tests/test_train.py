"""Training tests: recover a known potential's predictions from its own data."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mtp_jax.io.basis_gen import make_mtp
from mtp_jax.io.cfg_file import Config
from mtp_jax.md.simulation import make_lattice
from mtp_jax.models.mtp import MTPCoeffs, MTPModel
from mtp_jax.train.fit import Dataset, fit, linear_warm_start, loss_fn, make_dataset
from mtp_jax.utils import golden


@pytest.fixture(scope="module")
def teacher_data():
    """Configs labeled by a 'teacher' potential (golden engine, f64)."""
    m = make_mtp(8, species_count=1, seed=11)
    rng = np.random.default_rng(0)
    pos0, types, cell = make_lattice("fcc", 4.0, (3, 3, 3))
    configs = []
    for k in range(12):
        p = pos0 + rng.normal(scale=0.02 + 0.01 * (k % 6), size=pos0.shape)
        out = golden.compute(m, p, types, cell=cell)
        configs.append(
            Config(
                cell=cell,
                positions=p,
                types=types,
                energy=out["energy"],
                forces=out["forces"],
            )
        )
    return m, configs


def test_make_dataset(teacher_data):
    m, configs = teacher_data
    data = make_dataset(configs, m.max_dist, max_neighbors=48)
    assert data.n_configs == 12
    assert bool(data.real.all())
    assert bool(data.has_forces.all())


def test_self_consistency_zero_loss(teacher_data):
    """The teacher's own coefficients must give ~zero loss on its own labels
    (validates dataset plumbing + energy/force predictions end to end)."""
    m, configs = teacher_data
    model = MTPModel.from_data(m, dtype=jnp.float64)
    data = make_dataset(configs, m.max_dist, max_neighbors=48)
    l = float(loss_fn(model.schedule, model.coeffs, data, force_weight=1.0))
    assert l < 1e-16, l


def test_linear_warm_start_recovers_linear_coeffs(teacher_data):
    """With true radial coeffs fixed, the linear solve must recover species +
    moment coefficients (energies are exactly linear in them)."""
    m, configs = teacher_data
    model = MTPModel.from_data(m, dtype=jnp.float64)
    data = make_dataset(configs, m.max_dist, max_neighbors=48)
    scrambled = MTPCoeffs(
        radial_coeffs=model.coeffs.radial_coeffs,
        species_coeffs=jnp.zeros_like(model.coeffs.species_coeffs),
        moment_coeffs=jnp.zeros_like(model.coeffs.moment_coeffs),
    )
    fitted = linear_warm_start(model.schedule, scrambled, data)
    e_err = float(
        loss_fn(model.schedule, fitted, data, force_weight=0.0)
    )
    assert e_err < 1e-14, e_err


def test_fit_reduces_loss(teacher_data):
    """Adam from perturbed radial coefficients reduces the loss materially."""
    m, configs = teacher_data
    model = MTPModel.from_data(m, dtype=jnp.float64)
    data = make_dataset(configs, m.max_dist, max_neighbors=48)
    rng = np.random.default_rng(1)
    start = MTPCoeffs(
        radial_coeffs=model.coeffs.radial_coeffs
        * (1 + 0.3 * jnp.asarray(rng.normal(size=model.coeffs.radial_coeffs.shape))),
        species_coeffs=model.coeffs.species_coeffs,
        moment_coeffs=model.coeffs.moment_coeffs,
    )
    l0 = float(loss_fn(model.schedule, start, data))
    fitted, losses = fit(
        model.schedule, start, data, steps=60, learning_rate=1e-3
    )
    assert losses[-1] < 0.2 * l0, (l0, losses[-1])
