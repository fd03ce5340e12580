"""Time integrators: velocity-Verlet NVE, Langevin (BAOAB), Nose-Hoover-chain
NVT, and isotropic MTK NPT.

The reference relies on LAMMPS fixes for all of these (`fix 1 all nve`,
reference README.md:149; NPT enabled by the pair style's virial support,
pair_mtp.cpp:256-277). Here each integrator is a pure function
``(state, aux) -> (state, aux)`` suitable for `jax.lax.scan`.

The force evaluation is injected as ``force_fn(positions, types, cell) ->
(forces, potential_energy, virial)`` so integrators stay independent of the
potential and of neighbor-list management.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from mtp_jax.md.state import (
    MDState,
    kinetic_energy,
    temperature_of,
    volume_of,
)
from mtp_jax.utils import units

ForceFn = Callable


def _half_kick(state: MDState, dt):
    dv = (0.5 * dt * units.FTM2A) * state.forces / state.masses[:, None]
    return dataclasses.replace(state, velocities=state.velocities + dv)


def _drift(state: MDState, dt):
    return dataclasses.replace(
        state, positions=state.positions + dt * state.velocities
    )


def _with_forces(state: MDState, force_fn) -> MDState:
    f, pe, vir = force_fn(state.positions, state.types, state.cell)
    return dataclasses.replace(
        state, forces=f, potential_energy=pe, virial=vir
    )


# ----------------------------------------------------------------- NVE ----


def nve_step(state: MDState, force_fn: ForceFn, dt: float) -> MDState:
    """One velocity-Verlet step."""
    state = _half_kick(state, dt)
    state = _drift(state, dt)
    state = _with_forces(state, force_fn)
    state = _half_kick(state, dt)
    return dataclasses.replace(state, step=state.step + 1)


# ------------------------------------------------------------- Langevin ----


class LangevinAux(NamedTuple):
    key: jax.Array


def langevin_step(
    state: MDState,
    aux: LangevinAux,
    force_fn: ForceFn,
    dt: float,
    temperature: float,
    damping: float,
):
    """BAOAB Langevin dynamics; `damping` is the relaxation time [ps]."""
    key, sub = jax.random.split(aux.key)
    state = _half_kick(state, dt)
    state = _drift(state, 0.5 * dt)
    # O: Ornstein-Uhlenbeck exact update
    gamma = 1.0 / damping
    c1 = jnp.exp(-gamma * dt)
    sigma = jnp.sqrt(
        units.KB * temperature / (state.masses * units.MVV2E) * (1 - c1**2)
    )
    noise = jax.random.normal(sub, state.velocities.shape, state.velocities.dtype)
    v = c1 * state.velocities + sigma[:, None] * noise
    state = dataclasses.replace(state, velocities=v)
    state = _drift(state, 0.5 * dt)
    state = _with_forces(state, force_fn)
    state = _half_kick(state, dt)
    return dataclasses.replace(state, step=state.step + 1), LangevinAux(key)


# ------------------------------------------------------ Nose-Hoover NVT ----


class NHCAux(NamedTuple):
    """Nose-Hoover chain variables (length-2 chain)."""

    xi: jax.Array  # (2,) thermostat velocities
    eta: jax.Array  # (2,) thermostat positions (for the conserved quantity)


def nhc_init(dtype=jnp.float32) -> NHCAux:
    return NHCAux(xi=jnp.zeros(2, dtype), eta=jnp.zeros(2, dtype))


def _nhc_chain_half(ke2, ndof_t, xi, eta, dt, kt, q1, q2):
    """Half-step (dt/2 total) of a generic 2-link Nose-Hoover chain acting on
    a subsystem with twice-kinetic-energy `ke2` and `ndof_t` degrees of
    freedom. Returns (velocity scale, xi, eta).

    Standard MTK operator splitting: update link-2, damp+drive link-1, emit
    the subsystem velocity scale exp(-xi1*dt/2), then mirror the link
    updates. `xi` are chain velocities, `eta` their positions (needed only
    for the conserved quantity).
    """
    dt2, dt4, dt8 = 0.5 * dt, 0.25 * dt, 0.125 * dt

    g2 = (q1 * xi[0] ** 2 - kt) / q2
    xi = xi.at[1].add(g2 * dt4)
    xi = xi.at[0].multiply(jnp.exp(-xi[1] * dt8))
    g1 = (ke2 - ndof_t * kt) / q1
    xi = xi.at[0].add(g1 * dt4)
    xi = xi.at[0].multiply(jnp.exp(-xi[1] * dt8))

    scale = jnp.exp(-xi[0] * dt2)
    ke2 = ke2 * scale**2
    eta = eta + dt2 * xi

    xi = xi.at[0].multiply(jnp.exp(-xi[1] * dt8))
    g1 = (ke2 - ndof_t * kt) / q1
    xi = xi.at[0].add(g1 * dt4)
    xi = xi.at[0].multiply(jnp.exp(-xi[1] * dt8))
    g2 = (q1 * xi[0] ** 2 - kt) / q2
    xi = xi.at[1].add(g2 * dt4)

    return scale, xi, eta


def _nhc_half(state: MDState, aux: NHCAux, dt, temperature, tdamp):
    """Particle-thermostat half-step: 2-link NHC over the atomic KE."""
    ndof = 3 * state.n_atoms
    kt = units.KB * temperature
    scale, xi, eta = _nhc_chain_half(
        2.0 * kinetic_energy(state),
        ndof,
        aux.xi,
        aux.eta,
        dt,
        kt,
        q1=ndof * kt * tdamp**2,
        q2=kt * tdamp**2,
    )
    return (
        dataclasses.replace(state, velocities=state.velocities * scale),
        NHCAux(xi=xi, eta=eta),
    )


def nvt_conserved(state: MDState, aux: NHCAux, temperature: float, tdamp: float):
    """NHC-NVT conserved quantity H' = KE + PE + chain terms [eV]."""
    ndof = 3 * state.n_atoms
    kt = units.KB * temperature
    q1 = ndof * kt * tdamp**2
    q2 = kt * tdamp**2
    chain = (
        0.5 * q1 * aux.xi[0] ** 2
        + 0.5 * q2 * aux.xi[1] ** 2
        + ndof * kt * aux.eta[0]
        + kt * aux.eta[1]
    )
    return kinetic_energy(state) + state.potential_energy + chain


def nvt_step(
    state: MDState,
    aux: NHCAux,
    force_fn: ForceFn,
    dt: float,
    temperature: float,
    tdamp: float,
):
    """Nose-Hoover-chain NVT step (thermostat half, NVE core, thermostat half)."""
    state, aux = _nhc_half(state, aux, dt, temperature, tdamp)
    state = nve_step(state, force_fn, dt)
    state, aux = _nhc_half(state, aux, dt, temperature, tdamp)
    return state, aux


# ----------------------------------------------------------- MTK NPT -------


class NPTAux(NamedTuple):
    thermo: NHCAux  # particle thermostat chain
    baro_thermo: NHCAux  # barostat thermostat chain (its own 2-link NHC)
    baro_v: jax.Array  # () cell strain rate epsilon_dot = p_eps / W (isotropic)


def npt_init(dtype=jnp.float32) -> NPTAux:
    return NPTAux(
        thermo=nhc_init(dtype),
        baro_thermo=nhc_init(dtype),
        baro_v=jnp.zeros((), dtype),
    )


def _npt_masses(ndof, kt, tdamp, pdamp):
    """(W, Qb1, Qb2): barostat mass + barostat-chain masses (LAMMPS fix nh
    conventions: W = (ndof+3) kT pdamp^2, etap masses kT pdamp^2)."""
    w = (ndof + 3) * kt * pdamp**2
    return w, kt * pdamp**2, kt * pdamp**2


def npt_step(
    state: MDState,
    aux: NPTAux,
    force_fn: ForceFn,
    dt: float,
    temperature: float,
    pressure: float,
    tdamp: float,
    pdamp: float,
):
    """Isotropic Martyna-Tobias-Klein NPT step.

    `pressure` in bar. The cell is scaled isotropically. Trotter splitting
    follows LAMMPS `fix nh`: particle NHC -> barostat NHC (damps the barostat
    momentum) -> barostat force half-step -> barostat velocity coupling ->
    NVE core with cell-scaled drift -> mirrored closing half-steps. The
    barostat momentum p_eps is thermostatted by its OWN 2-link NHC at the
    same temperature (the MTK ensemble requirement).
    """
    n = state.n_atoms
    ndof = 3 * n
    kt = units.KB * temperature
    p_ext = pressure / units.EVA3_TO_BAR  # eV/A^3
    w, qb1, qb2 = _npt_masses(ndof, kt, tdamp, pdamp)

    def baro_chain_half(aux):
        ke2 = w * aux.baro_v**2  # p_eps^2 / W
        scale, xi, eta = _nhc_chain_half(
            ke2, 1, aux.baro_thermo.xi, aux.baro_thermo.eta, dt, kt, qb1, qb2
        )
        return NPTAux(
            thermo=aux.thermo,
            baro_thermo=NHCAux(xi=xi, eta=eta),
            baro_v=aux.baro_v * scale,
        )

    def omega_dot_half(state, aux):
        bv = mtk_iso_omega_half(
            aux.baro_v,
            vol=volume_of(state),
            w_tr=state.virial[0] + state.virial[1] + state.virial[2],
            ke2=2.0 * kinetic_energy(state),
            dt=dt, ndof=ndof, p_ext=p_ext, w_b=w,
        )
        return aux._replace(baro_v=bv)

    def v_press_half(state, aux):
        alpha = mtk_iso_vscale(aux.baro_v, dt, ndof)
        return dataclasses.replace(state, velocities=state.velocities * alpha)

    # opening half: thermostats, barostat force, barostat-velocity coupling
    state, thermo = _nhc_half(state, aux.thermo, dt, temperature, tdamp)
    aux = aux._replace(thermo=thermo)
    aux = baro_chain_half(aux)
    aux = omega_dot_half(state, aux)
    state = v_press_half(state, aux)
    state = _half_kick(state, dt)

    # drift with cell scaling: the exact MTK position map (mtk_iso_maps)
    s, d = mtk_iso_maps(aux.baro_v, dt)
    state = dataclasses.replace(
        state,
        positions=state.positions * s + dt * state.velocities * d,
        cell=state.cell * s,
    )

    state = _with_forces(state, force_fn)

    # closing half (mirror order)
    state = _half_kick(state, dt)
    state = v_press_half(state, aux)
    aux = omega_dot_half(state, aux)
    aux = baro_chain_half(aux)
    state, thermo = _nhc_half(state, aux.thermo, dt, temperature, tdamp)
    state = dataclasses.replace(state, step=state.step + 1)
    return state, aux._replace(thermo=thermo)


# ------------------------------------------------- anisotropic MTK NPT -----


class NPTAnisoAux(NamedTuple):
    """Full-cell MTK barostat state (Parrinello-Rahman-style cell dynamics
    with the MTK kinetic corrections)."""

    thermo: NHCAux  # particle thermostat chain
    baro_thermo: NHCAux  # barostat thermostat chain
    baro_v: jax.Array  # (3, 3) symmetric cell strain-rate tensor p_g / W


def npt_aniso_init(dtype=jnp.float32) -> NPTAnisoAux:
    return NPTAnisoAux(
        thermo=nhc_init(dtype),
        baro_thermo=nhc_init(dtype),
        baro_v=jnp.zeros((3, 3), dtype),
    )


def _mm3(a, b):
    """(3,3) @ (3,3) at HIGHEST precision. A default-precision f32 matmul
    may round its operands (TF32 keeps ~10 mantissa bits: ~0.1 A on a
    252 A box). Every cell/velocity transform here must be exact f32."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _xm3(x, m):
    """(N,3) @ (3,3) unrolled per component: exact f32 elementwise
    arithmetic (no matmul operand rounding, see :func:`_mm3`; as
    models/mtp.minimum_image)."""
    return jnp.stack(
        [
            x[:, 0] * m[0, a] + x[:, 1] * m[1, a] + x[:, 2] * m[2, a]
            for a in range(3)
        ],
        axis=1,
    )


def _sym_expm(a):
    """exp(A) for a small symmetric (3,3) A by 4th-order series (barostat
    strain increments are ~dt*eps_dot ~ 1e-4; the series truncation error
    ~|A|^5 is far below fp precision — no eigh needed on the hot path)."""
    eye = jnp.eye(3, dtype=a.dtype)
    a2 = _mm3(a, a)
    return eye + a + a2 / 2.0 + _mm3(a2, a) / 6.0 + _mm3(a2, a2) / 24.0


def _sinh_ratio_m(a):
    """f(A) = sinh(A/2)/(A/2) as a series in A^2 (commutes with exp(A))."""
    eye = jnp.eye(3, dtype=a.dtype)
    a2 = _mm3(a, a)
    return eye + a2 / 24.0 + _mm3(a2, a2) / 1920.0


def _voigt_to_tensor(v):
    """Voigt (xx,yy,zz,xy,xz,yz) -> symmetric (3,3)."""
    return jnp.asarray(
        [
            [v[0], v[3], v[4]],
            [v[3], v[1], v[5]],
            [v[4], v[5], v[2]],
        ]
    )


def _tensor_to_voigt(m):
    """Symmetric (3,3) -> Voigt (xx,yy,zz,xy,xz,yz)."""
    return jnp.asarray(
        [m[0, 0], m[1, 1], m[2, 2], m[0, 1], m[0, 2], m[1, 2]]
    )


# ------------------------------------------------ shared MTK pieces --------
# Single source of truth for the barostat math. All inputs are ALREADY
# REDUCED scalars/tensors (KE, virial, kinetic tensor): the single-device
# steps pass plain sums, the sharded engines psum over the mesh first, and
# the numerics, including every matmul-precision pin, live in exactly one
# place.


def mtk_ke_tensor(vel, mass_col, real=None):
    """m v v^T summed over atoms, in energy units: the kinetic part of the
    internal pressure tensor. HIGHEST: a default-precision f32 matmul may
    round the operands of this (3,N)@(N,3) reduction (TF32), and it drives
    the barostat every step."""
    mv = vel * mass_col
    if real is not None:
        mv = jnp.where(real[:, None], mv, 0.0)
    return units.MVV2E * jnp.matmul(
        mv.T, vel, precision=jax.lax.Precision.HIGHEST
    )


def mtk_iso_omega_half(bv, *, vol, w_tr, ke2, dt, ndof, p_ext, w_b):
    """Isotropic barostat momentum half-kick: eps_dot += dt/2 * G_eps with
    the MTK (d/ndof)*2KE correction. `w_tr` = virial trace."""
    p_int = (ke2 + w_tr) / (3.0 * vol)
    g = (3.0 * vol * (p_int - p_ext) + (3.0 / ndof) * ke2) / w_b
    return bv + 0.5 * dt * g


def mtk_iso_vscale(bv, dt, ndof):
    """Velocity damping factor of the iso barostat coupling half-step."""
    return jnp.exp(-0.5 * dt * (1.0 + 3.0 / ndof) * bv)


def mtk_iso_maps(bv, dt):
    """(s, d) of the exact iso MTK position map (series-expanded sinh):
    pos' = pos*s + dt*vel*d, cell' = cell*s."""
    x = dt * bv
    s = jnp.exp(x)
    x2 = (0.5 * x) ** 2
    sinh_ratio = 1.0 + x2 / 6.0 + x2**2 / 120.0
    return s, jnp.exp(0.5 * x) * sinh_ratio


def mtk_aniso_omega_half(
    bv, *, mvv, vir6, vol, ke2, dt, ndof, p_ext, w_b, couple
):
    """Tensor-barostat momentum half-kick: p_g/W += dt/2 * G with
    G = [V(P_int - p_ext I) + (2KE/ndof) I]/W. `mvv` from
    :func:`mtk_ke_tensor`; `couple` = "tri" (all six modes) or "aniso"
    (diagonal only)."""
    eye = jnp.eye(3, dtype=bv.dtype)
    p_int = (mvv + _voigt_to_tensor(vir6)) / vol
    g = (vol * (p_int - p_ext * eye) + (ke2 / ndof) * eye) / w_b
    g = 0.5 * (g + g.T)  # keep p_g exactly symmetric under fp roundoff
    step = 0.5 * dt * g
    if couple != "tri":
        step = step * eye
    return bv + step


def mtk_aniso_vscale(bv, dt, ndof):
    """Velocity-coupling matrix exp(-dt/2 (p_g/W + Tr(p_g/W)/ndof I))."""
    eye = jnp.eye(3, dtype=bv.dtype)
    return _sym_expm(-0.5 * dt * (bv + (jnp.trace(bv) / ndof) * eye))


def mtk_aniso_maps(bv, dt):
    """(E, D) of the exact aniso MTK position map (matrix series, all
    factors commute): pos' = pos@E + dt*vel@D, cell' = cell@E."""
    a = dt * bv
    return _sym_expm(a), _mm3(_sym_expm(0.5 * a), _sinh_ratio_m(a))


def npt_aniso_step(
    state: MDState,
    aux: NPTAnisoAux,
    force_fn: ForceFn,
    dt: float,
    temperature: float,
    pressure: float,
    tdamp: float,
    pdamp: float,
    couple: str = "tri",
):
    """Anisotropic Martyna-Tobias-Klein NPT step (full-cell / triclinic).

    The LAMMPS `fix npt ... aniso/tri` surface the reference inherits (its
    virial support exists to serve exactly this, pair_mtp.cpp:256-277).
    The barostat momentum is a symmetric (3,3) tensor p_g; `couple="aniso"`
    restricts it to the diagonal (cell stays orthorhombic), `couple="tri"`
    evolves all six modes (cell may tilt). The same Trotter splitting as
    :func:`npt_step` with every scalar barostat map promoted to a matrix
    function of p_g/W (series-evaluated; all factors commute).

    `pressure` [bar] is the hydrostatic external target p_ext*I.
    """
    n = state.n_atoms
    ndof = 3 * n
    kt = units.KB * temperature
    p_ext = pressure / units.EVA3_TO_BAR  # eV/A^3
    w, qb1_unit, qb2 = _npt_masses(ndof, kt, tdamp, pdamp)
    n_modes = 6 if couple == "tri" else 3
    qb1 = n_modes * qb1_unit

    def baro_chain_half(aux):
        ke2 = w * jnp.sum(aux.baro_v * aux.baro_v)  # Tr(p_g^2)/W
        scale, xi, eta = _nhc_chain_half(
            ke2, n_modes, aux.baro_thermo.xi, aux.baro_thermo.eta, dt, kt,
            qb1, qb2,
        )
        return aux._replace(
            baro_thermo=NHCAux(xi=xi, eta=eta), baro_v=aux.baro_v * scale
        )

    def omega_dot_half(state, aux):
        bv = mtk_aniso_omega_half(
            aux.baro_v,
            mvv=mtk_ke_tensor(state.velocities, state.masses[:, None]),
            vir6=state.virial,
            vol=volume_of(state),
            ke2=2.0 * kinetic_energy(state),
            dt=dt, ndof=ndof, p_ext=p_ext, w_b=w, couple=couple,
        )
        return aux._replace(baro_v=bv)

    def v_press_half(state, aux):
        alpha = mtk_aniso_vscale(aux.baro_v, dt, ndof)
        return dataclasses.replace(
            state, velocities=_xm3(state.velocities, alpha)
        )

    state, thermo = _nhc_half(state, aux.thermo, dt, temperature, tdamp)
    aux = aux._replace(thermo=thermo)
    aux = baro_chain_half(aux)
    aux = omega_dot_half(state, aux)
    state = v_press_half(state, aux)
    state = _half_kick(state, dt)

    # drift with cell deformation: the matrix analog of the exact iso map
    # r' = r E + dt v D,  h' = h E (mtk_aniso_maps)
    e_full, d_mat = mtk_aniso_maps(aux.baro_v, dt)
    state = dataclasses.replace(
        state,
        positions=_xm3(state.positions, e_full)
        + dt * _xm3(state.velocities, d_mat),
        cell=_mm3(state.cell, e_full),
    )

    state = _with_forces(state, force_fn)

    state = _half_kick(state, dt)
    state = v_press_half(state, aux)
    aux = omega_dot_half(state, aux)
    aux = baro_chain_half(aux)
    state, thermo = _nhc_half(state, aux.thermo, dt, temperature, tdamp)
    state = dataclasses.replace(state, step=state.step + 1)
    return state, aux._replace(thermo=thermo)


def npt_aniso_conserved(
    state: MDState,
    aux: NPTAnisoAux,
    temperature: float,
    pressure: float,
    tdamp: float,
    pdamp: float,
    couple: str = "tri",
):
    """Aniso-MTK conserved quantity H' = KE + PE + Tr(p_g^2)/(2W) + P_ext V
    + particle-chain + barostat-chain terms [eV]."""
    ndof = 3 * state.n_atoms
    kt = units.KB * temperature
    p_ext = pressure / units.EVA3_TO_BAR
    w, qb1_unit, qb2 = _npt_masses(ndof, kt, tdamp, pdamp)
    n_modes = 6 if couple == "tri" else 3
    qb1 = n_modes * qb1_unit
    q1 = ndof * kt * tdamp**2
    q2 = kt * tdamp**2
    t = aux.thermo
    b = aux.baro_thermo
    chain = (
        0.5 * q1 * t.xi[0] ** 2
        + 0.5 * q2 * t.xi[1] ** 2
        + ndof * kt * t.eta[0]
        + kt * t.eta[1]
    )
    baro_chain = (
        0.5 * qb1 * b.xi[0] ** 2
        + 0.5 * qb2 * b.xi[1] ** 2
        + kt * (n_modes * b.eta[0] + b.eta[1])
    )
    return (
        kinetic_energy(state)
        + state.potential_energy
        + 0.5 * w * jnp.sum(aux.baro_v * aux.baro_v)
        + p_ext * volume_of(state)
        + chain
        + baro_chain
    )


def npt_conserved(
    state: MDState,
    aux: NPTAux,
    temperature: float,
    pressure: float,
    tdamp: float,
    pdamp: float,
):
    """MTK conserved quantity H' = KE + PE + W eps_dot^2/2 + P_ext V
    + particle-chain terms + barostat-chain terms [eV]."""
    ndof = 3 * state.n_atoms
    kt = units.KB * temperature
    p_ext = pressure / units.EVA3_TO_BAR
    w, qb1, qb2 = _npt_masses(ndof, kt, tdamp, pdamp)
    q1 = ndof * kt * tdamp**2
    q2 = kt * tdamp**2
    t = aux.thermo
    b = aux.baro_thermo
    chain = (
        0.5 * q1 * t.xi[0] ** 2
        + 0.5 * q2 * t.xi[1] ** 2
        + ndof * kt * t.eta[0]
        + kt * t.eta[1]
    )
    baro_chain = (
        0.5 * qb1 * b.xi[0] ** 2
        + 0.5 * qb2 * b.xi[1] ** 2
        + kt * (b.eta[0] + b.eta[1])
    )
    return (
        kinetic_energy(state)
        + state.potential_energy
        + 0.5 * w * aux.baro_v**2
        + p_ext * volume_of(state)
        + chain
        + baro_chain
    )
