"""Virial validation against strain finite differences.

Thermodynamic identity: for an affine deformation x -> (I+eps) x,
h -> h (I+eps)^T, the virial tensor satisfies W_ab = -dE/d(eps_ab) at eps=0.
This pins the sign/normalization conventions (the reference's Voigt layout,
pair_mtp.cpp:257-266) to actual thermodynamics.
"""

import numpy as np
import pytest

from mtp_jax.io.basis_gen import make_mtp
from mtp_jax.md.simulation import make_lattice
from mtp_jax.utils import golden


@pytest.mark.parametrize("seed", [0, 3])
def test_virial_matches_strain_derivative(seed, rng):
    m = make_mtp(8, species_count=1, seed=seed)
    pos0, types, cell0 = make_lattice("fcc", 4.0, (3, 3, 3))
    pos0 = pos0 + rng.normal(scale=0.06, size=pos0.shape)

    out = golden.compute(m, pos0, types, cell=cell0)
    W = out["virial"]  # Voigt xx,yy,zz,xy,xz,yz

    h = 1e-6

    def energy_at_strain(eps):
        F = np.eye(3) + eps
        return golden.compute(m, pos0 @ F.T, types, cell=cell0 @ F.T)["energy"]

    # diagonal components
    for a, voigt in ((0, 0), (1, 1), (2, 2)):
        eps = np.zeros((3, 3))
        eps[a, a] = h
        ep = energy_at_strain(eps)
        eps[a, a] = -h
        em = energy_at_strain(eps)
        dE = (ep - em) / (2 * h)
        assert W[voigt] == pytest.approx(-dE, rel=1e-4, abs=1e-6), (a, W[voigt], -dE)

    # shear components (symmetrized strain; Voigt 3=xy, 4=xz, 5=yz)
    for (a, b), voigt in (((0, 1), 3), ((0, 2), 4), ((1, 2), 5)):
        eps = np.zeros((3, 3))
        eps[a, b] = eps[b, a] = h
        ep = energy_at_strain(eps)
        eps[a, b] = eps[b, a] = -h
        em = energy_at_strain(eps)
        dE = (ep - em) / (2 * h)
        # symmetric shear strain couples to W_ab + W_ba = 2 W_voigt
        assert 2 * W[voigt] == pytest.approx(-dE, rel=1e-4, abs=1e-6)
