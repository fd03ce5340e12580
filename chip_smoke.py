#!/usr/bin/env python3
"""Device smoke test: the MD engine's main paths on NVIDIA GPUs.

    python chip_smoke.py          # phases 1-4 on one GPU
    python chip_smoke.py --four   # the sharded engine on four GPUs, and
                                  # what it is compared with, only

Every phase goes through the entry points a user calls (`Simulation`,
`run_with_extrapolation`, `ShardedSimulation`,
`run_sharded_with_extrapolation`) with the repository's widest potential (a
level-16 MTP, J = 64) on the 32,000-atom fcc box of bench.py (the
1,000,188-atom box with --four). Potentials are minted from a fixed seed.

The script refuses to run anywhere but a GPU and never falls back to the
CPU; a failing phase fails the script. It prints the card's name and power
limit, each phase's compile seconds and the device's peak memory, and ends
with one JSON line:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1 or 4}}
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

# Tolerances of the fp32 device path against XLA at float64 on the same
# card. E: fp32 rounding of ~600 DAG products per atom, summed into a site
# energy of ~-5 eV, stays near 1e-7 eV/atom. F: the 5e-4 eV/A on-device gate
# the fused kernels were held to; fp32 pair forces carry ~1e-5 relative
# error. W: the total virial sums ~60 pair terms of O(1) eV per atom in fp32,
# so it is extensive, and so is its rounding: 5e-2 eV at bench.py's 32,000
# atoms, scaled with the atom count (1.6 eV at 1M atoms).
E_TOL = 1e-6  # eV/atom
F_TOL = 5e-4  # eV/A
W_TOL_PER_ATOM = 5e-2 / 32000  # eV/atom


def _within(d, n):
    """Whether a `_diff` record of an n-atom box meets the fp32 gates."""
    return (d["de_atom"] <= E_TOL and d["df_max"] <= F_TOL
            and d["dw_max"] <= W_TOL_PER_ATOM * n)


# float64 on the card against the loop-level oracle (utils/golden.py): the
# two differ only in summation order.
GOLDEN_E_TOL = 1e-9  # eV/atom
GOLDEN_F_TOL = 1e-8  # eV/A
GOLDEN_W_TOL = 1e-7  # eV
# Grades are max_k |sum_l invA_kl b_il|, a sum that cancels heavily: its
# terms reach ~1e4 for grades of ~1. So a grade's error is bounded relative
# to the cancellation scale max_ik sum_l |invA_kl b_il|: fp32 leaves
# ~sqrt(P) * 6e-8 of it (P ~ 200 coefficients), a TF32 product ~1e-4 or
# more.
GRADE_TOL = 1e-6  # of the cancellation scale

LEVEL = 16
J = 64
SKIN = 0.6
LATTICE = 4.0


@dataclasses.dataclass
class Size:
    """Box and potential of a run; tests shrink it to run on the CPU."""

    reps: tuple = (20, 20, 20)  # 32,000 atoms
    golden_reps: tuple = (4, 4, 4)  # 256 atoms
    level: int = LEVEL
    spb: int = 30
    blocks: int = 3
    eq_steps: int = 60


class CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration


def _potential(species, level, dtype):
    from mtp_jax.io.basis_gen import make_mtp
    from mtp_jax.models.mtp import MTPModel

    m = make_mtp(level, species_count=species, seed=0)
    return m, MTPModel.from_data(m, dtype=dtype)


def _box(reps, species, rattle=0.05, seed=0):
    from mtp_jax.md.simulation import make_lattice

    pos, types, cell = make_lattice(
        "fcc", LATTICE, reps, type_pattern=(0, 1) if species == 2 else (0,)
    )
    rng = np.random.default_rng(seed)
    return pos + rng.normal(0.0, rattle, pos.shape), types, cell


def _state(pos, types, cell, dtype, temperature=None, seed=0):
    import jax

    from mtp_jax.md.state import init_state, thermalize

    st = init_state(pos, types, np.full(len(pos), 58.693), cell, dtype=dtype)
    if temperature is not None:
        st = thermalize(jax.random.PRNGKey(seed), st, temperature)
    return st


def _eval(model, state, backend="auto"):
    """Energy, forces and virial of `state` through Simulation's own
    rebuild + force refresh; fails on neighbor overflow."""
    from mtp_jax.md.simulation import Simulation
    from mtp_jax.ops.neighbors import grid_shape

    sim = Simulation(model, max_neighbors=J, skin=SKIN, compute_virial=True,
                     backend=backend)
    grid = grid_shape(np.asarray(state.cell), model.cutoff + SKIN)
    nl = sim.rebuild(state, grid=grid, max_neighbors=J)
    out = sim.refresh_forces(state, nl)
    if bool(nl.overflow):
        raise RuntimeError("neighbor overflow at J=%d" % J)
    return (
        float(out.potential_energy),
        np.asarray(out.forces, np.float64),
        np.asarray(out.virial, np.float64),
    )


def _diff(a, b, n):
    return dict(
        de_atom=abs(a[0] - b[0]) / n,
        df_max=float(np.abs(a[1] - b[1]).max()),
        dw_max=float(np.abs(a[2] - b[2]).max()),
    )


def phase_force_parity(size: Size, species=2):
    """fp32 forces at full width, through the default force path (the fused
    kernel on a GPU) and the XLA path, against XLA float64 on the same
    device; float64 on a 256-atom box against the loop-level oracle."""
    import jax.numpy as jnp

    from mtp_jax.models.mtp import resolve_backend
    from mtp_jax.utils import golden

    m, m32 = _potential(species, size.level, jnp.float32)
    _, m64 = _potential(species, size.level, jnp.float64)
    pos, types, cell = _box(size.reps, species)
    n = len(pos)
    pos32 = np.asarray(pos, np.float32)
    st32 = _state(pos32, types, cell, jnp.float32)
    r64 = _eval(m64, _state(pos32.astype(np.float64), types, cell,
                            jnp.float64))
    ok, fp32 = True, {}
    for path in sorted({resolve_backend("auto", jnp.float32), "xla"}):
        d = _diff(_eval(m32, st32, path), r64, n)
        ok &= _within(d, n)
        fp32[path] = d

    gpos, gtypes, gcell = _box(size.golden_reps, species, seed=1)
    rg = _eval(m64, _state(gpos, gtypes, gcell, jnp.float64))
    g = golden.compute(m, gpos, gtypes, cell=gcell)
    dg = _diff(rg, (g["energy"], g["forces"], g["virial"]), len(gpos))
    ok_g = (dg["de_atom"] <= GOLDEN_E_TOL and dg["df_max"] <= GOLDEN_F_TOL
            and dg["dw_max"] <= GOLDEN_W_TOL)
    return ok and ok_g, dict(
        atoms=n, species=species, fp32_vs_f64=fp32, f64_vs_golden=dg,
        golden_atoms=len(gpos),
    )


def _kinetic(state):
    from mtp_jax.md.state import kinetic_energy

    return float(kinetic_energy(state))


def _total_energy(state):
    return float(state.potential_energy) + _kinetic(state)


def phase_md(size: Size, species=2):
    """NVE blocks after bench.py's equilibration, then one NPT block with
    per-step stress; no overflow, no staleness, finite state."""
    import jax.numpy as jnp

    from mtp_jax.md.simulation import Simulation
    from mtp_jax.md.state import pressure_of

    _, m32 = _potential(species, size.level, jnp.float32)
    pos, types, cell = _box(size.reps, species, rattle=0.0)
    state = _state(pos, types, cell, jnp.float32, temperature=300.0)
    n = len(pos)
    eq = Simulation(m32, max_neighbors=J, skin=SKIN, steps_per_rebuild=10,
                    compute_virial=False)
    state, _, flags = eq.run_async(state, size.eq_steps, ensemble="nve",
                                   dt=0.001)
    eq_ok = not bool(flags)

    sim = Simulation(m32, max_neighbors=J, skin=SKIN,
                     steps_per_rebuild=size.spb, compute_virial=False)
    energies = [_total_energy(state)]
    state, _ = sim.run(state, size.blocks * size.spb, ensemble="nve",
                       dt=0.001,
                       observer=lambda s: energies.append(_total_energy(s)))
    nve_ok = sim.max_neighbors == J and sim.steps_per_rebuild == size.spb
    drift = (energies[-1] - energies[0]) / n

    npt = Simulation(m32, max_neighbors=J, skin=SKIN,
                     steps_per_rebuild=size.spb, compute_virial=True)
    state, _ = npt.run(state, size.spb, ensemble="npt", dt=0.001,
                       temperature=300.0, pressure=0.0, tdamp=0.1, pdamp=1.0)
    p_bar = float(pressure_of(state))
    npt_ok = (npt.max_neighbors == J and npt.steps_per_rebuild == size.spb
              and np.isfinite(p_bar)
              and np.isfinite(np.asarray(state.positions)).all())
    return eq_ok and nve_ok and npt_ok, dict(
        atoms=n, nve_steps=size.blocks * size.spb,
        nve_drift_ev_per_atom=drift,
        block_energies_ev_per_atom=[e / n for e in energies],
        npt_pressure_bar=p_bar,
    )


def _with_mvs(model, m, size: Size, species):
    """`model` with an MVS selection state built from float64 candidate
    vectors of two rattled small boxes of the same potential."""
    import jax.numpy as jnp

    from mtp_jax.al.grades import candidate_vectors
    from mtp_jax.al.maxvol import build_mvs
    from mtp_jax.models.mtp import MTPModel
    from mtp_jax.ops.neighbors import build_neighbor_list_bruteforce

    m64 = MTPModel.from_data(m, dtype=jnp.float64)
    rows = []
    for k, rattle in enumerate((0.03, 0.1)):
        pos, types, cell = _box(size.golden_reps, species, rattle, seed=10 + k)
        nl = build_neighbor_list_bruteforce(
            jnp.asarray(pos), jnp.asarray(cell), m64.cutoff, max_neighbors=J
        )
        b, _ = candidate_vectors(
            m64.schedule, m64.coeffs, jnp.asarray(pos),
            jnp.asarray(types, jnp.int32), nl.idx, jnp.asarray(cell),
        )
        rows.append(np.asarray(b))
    mvs = build_mvs(np.concatenate(rows), mode="neighborhood")
    return dataclasses.replace(
        model,
        inverse_active_set=jnp.asarray(
            mvs.inverse_active_set, model.coeffs.moment_coeffs.dtype
        ),
        configuration_mode=False,
    )


def phase_active_learning(size: Size, species=2):
    """`run_with_extrapolation` with one grade step after the initial
    evaluation; fp32 grades against float64 grades of the same state."""
    import jax.numpy as jnp

    from mtp_jax.al.driver import ExtrapolationMonitor, run_with_extrapolation
    from mtp_jax.md.simulation import Simulation

    m, m32 = _potential(species, size.level, jnp.float32)
    _, m64 = _potential(species, size.level, jnp.float64)
    m32 = _with_mvs(m32, m, size, species)
    m64 = _with_mvs(m64, m, size, species)
    pos, types, cell = _box(size.reps, species, rattle=0.05)
    state = _state(pos, types, cell, jnp.float32, temperature=300.0)
    sim = Simulation(m32, max_neighbors=J, skin=SKIN, steps_per_rebuild=10,
                     compute_virial=False)
    mon = ExtrapolationMonitor(m32, max_neighbors=J)
    state = run_with_extrapolation(sim, mon, state, size.spb,
                                   al_every=size.spb, ensemble="nve",
                                   dt=0.001)
    g32 = np.asarray(mon.nbh_grades, np.float64)
    st64 = _state(np.asarray(state.positions, np.float64), types, cell,
                  jnp.float64)
    g64, scale = _grades_and_scale(m64, st64)
    err = float(np.abs(g32 - g64).max())
    return err <= GRADE_TOL * scale, dict(
        atoms=len(pos), max_grade_fp32=float(g32.max()),
        max_grade_f64=float(g64.max()), grade_max_abs_err=err,
        grade_cancellation_scale=scale,
    )


def _grades_and_scale(model, state):
    """Neighborhood grades of `state` and their cancellation scale
    max_ik sum_l |invA_kl b_il| (see GRADE_TOL)."""
    import jax.numpy as jnp

    from mtp_jax.al.grades import candidates_and_forces, nbh_grades
    from mtp_jax.ops.neighbors import build_neighbor_list, grid_shape

    cell = np.asarray(state.cell)
    nl = build_neighbor_list(
        state.positions, state.cell, model.cutoff, max_neighbors=J,
        grid=grid_shape(cell, model.cutoff), with_reverse=True,
    )
    if bool(nl.overflow):
        raise RuntimeError("neighbor overflow at J=%d" % J)
    b = candidates_and_forces(
        model.schedule, model.coeffs, state.positions, state.types, nl.idx,
        state.cell, nl.mirror,
    )["b"]
    inv = model.inverse_active_set
    scale = jnp.max(jnp.matmul(jnp.abs(b), jnp.abs(inv).T,
                               precision="highest"))
    return np.asarray(nbh_grades(b, inv), np.float64), float(scale)


def phase_exactness():
    """The integrator's 3x3 transforms stay exact fp32 elementwise
    arithmetic (a TF32 matmul would round coordinates), and the df32
    error-free transforms are exact on the device."""
    import jax
    import jax.numpy as jnp

    from mtp_jax.md import integrators as itg
    from mtp_jax.ops import df32 as dfm

    rng = np.random.default_rng(1)
    p64 = rng.uniform(0, 252.0, (4096, 3))
    e64 = np.eye(3) + rng.normal(0, 1e-5, (3, 3))
    e32 = jnp.asarray(e64, jnp.float32)
    dr = np.asarray(jax.jit(itg._xm3)(jnp.asarray(p64, jnp.float32), e32),
                    np.float64)
    dmax = float(np.abs(dr - p64 @ e64).max())
    h = np.asarray(
        jax.jit(itg._mm3)(jnp.asarray(e64 * 252.0, jnp.float32), e32),
        np.float64,
    )
    hmax = float(np.abs(h - (e64 * 252.0) @ e64).max())

    a = rng.uniform(-100, 100, 8192).astype(np.float32)
    b = rng.uniform(-100, 100, 8192).astype(np.float32)

    @jax.jit
    def eft(a, b):
        return (*dfm.two_sum(a, b), *dfm.two_prod(a, b))

    s, e, p, q = (np.asarray(x, np.float64)
                  for x in eft(jnp.asarray(a), jnp.asarray(b)))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    two_sum_exact = bool(np.array_equal(s + e, a64 + b64))
    two_prod_exact = bool(np.array_equal(p + q, a64 * b64))
    ok = dmax < 5e-4 and hmax < 5e-4 and two_sum_exact and two_prod_exact
    return ok, dict(xm3_max_err=dmax, mm3_max_err=hmax,
                    two_sum_exact=two_sum_exact,
                    two_prod_exact=two_prod_exact)


# ------------------------------------------------------------- four cards


def _sharded(model, pos, vel, types, masses, cell, mesh_kind, nd, size):
    from mtp_jax.ops.neighbors import grid_shape
    from mtp_jax.parallel.domain import partition_bricks, partition_slabs
    from mtp_jax.parallel.sharded_md import ShardedState, make_mesh, make_mesh_2d
    from mtp_jax.parallel.sharded_window import ShardedSimulation

    n = len(pos)
    w_cut = model.cutoff + SKIN
    if mesh_kind == "slabs":
        mesh = make_mesh(nd)
        part = partition_slabs(pos, vel, types, masses, cell, nd,
                               cutoff=w_cut)
    else:
        shape = (2, nd // 2)
        mesh = make_mesh_2d(shape)
        part = partition_bricks(
            pos, vel, types, masses, cell, shape, cutoff=w_cut,
            capacity=int(np.ceil((n / nd * 1.3 + 16) / 8) * 8),
        )
    sstate = ShardedState.from_partition(
        part, cell, mesh, dtype=model.coeffs.moment_coeffs.dtype
    )
    sim = ShardedSimulation(
        model, mesh, capacity=part.capacity, max_neighbors=J,
        grid=grid_shape(cell, w_cut), skin=SKIN, steps_per_rebuild=size.spb,
        compute_virial=True,
    )
    return sim, sstate


def _device_check(sstate, nd):
    """Whether every device holds a shard of the atoms, and each device's
    peak memory (None where the platform keeps no statistics)."""
    import jax

    shards = sstate.positions.addressable_shards
    on_all = (len(sstate.positions.sharding.device_set) == nd
              and len({s.device for s in shards}) == nd
              and all(s.data.shape[0] > 0 for s in shards))
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.devices()[:nd]]
    return on_all, peaks


def phase_sharded(size: Size, nd=4, species=2, meshes=("slabs", "bricks")):
    """ShardedSimulation against single-device Simulation on the same state:
    step-0 energy/forces/virial, NVE drift, and one sharded grade step."""
    import jax.numpy as jnp

    from mtp_jax.al.driver import (
        ShardedExtrapolationMonitor,
        run_sharded_with_extrapolation,
    )
    from mtp_jax.md.simulation import Simulation
    from mtp_jax.parallel.observables import gather_md_state, sharded_kinetic_energy

    m, m32 = _potential(species, size.level, jnp.float32)
    m32 = _with_mvs(m32, m, size, species)
    pos, types, cell = _box(size.reps, species, rattle=0.0)
    state = _state(pos, types, cell, jnp.float32, temperature=300.0)
    n = len(pos)
    vel = np.asarray(state.velocities)
    masses = np.full(n, 58.693)

    ref0 = _eval(m32, state)
    sim1 = Simulation(m32, max_neighbors=J, skin=SKIN,
                      steps_per_rebuild=size.spb, compute_virial=False)
    e1 = [ref0[0] + _kinetic(state)]
    st1, _ = sim1.run(state, size.blocks * size.spb, ensemble="nve",
                      dt=0.001, observer=lambda s: e1.append(_total_energy(s)))
    drift1 = (e1[-1] - e1[0]) / n

    ok_all, out = True, dict(atoms=n, single_nve_drift_ev_per_atom=drift1)
    for kind in meshes:
        sim, sstate = _sharded(m32, pos, vel, types, masses, cell, kind, nd,
                               size)
        st, ctx, f4 = sim.rebuild(sstate)
        st, _ = sim.steps(st, ctx, 0, refresh=True)
        shard0 = (float(st.potential_energy),
                  st.gather(np.asarray(st.forces), n).astype(np.float64),
                  np.asarray(st.virial, np.float64))
        d0 = _diff(shard0, ref0, n)
        flags0 = not any(bool(f) for f in f4)

        def e_tot(s):
            return float(s.potential_energy) + float(sharded_kinetic_energy(s))

        es = [shard0[0] + float(sharded_kinetic_energy(sstate))]
        sst, flags = sim.run(sstate, size.blocks * size.spb, ensemble="nve",
                             dt=0.001, observer=lambda s: es.append(e_tot(s)))
        drift = (es[-1] - es[0]) / n
        final = gather_md_state(sst, n)
        dpos = float(np.abs(np.asarray(final.positions, np.float64)
                            - np.asarray(st1.positions, np.float64)).max())

        mon = ShardedExtrapolationMonitor(
            m32, sim.mesh, capacity=sim.capacity, grid=sim.grid, n_atoms=n,
            max_neighbors=J,
        )
        graded = run_sharded_with_extrapolation(
            sim, mon, sstate, size.spb, al_every=size.spb, ensemble="nve",
            dt=0.001)
        g = np.asarray(mon.nbh_grades, np.float64)
        # single-device grades of the state the sharded grade step saw: the
        # two trajectories part by ~1e-5 A within a block, and a grade
        # amplifies that by its cancellation scale (~1e5)
        g1, scale = _grades_and_scale(m32, gather_md_state(graded, n))
        grade_err = float(np.abs(g - g1).max())
        on_all, peaks = _device_check(sst, nd)
        dev_ok = on_all and all(p is not None and p > 0 for p in peaks)
        ok = (flags0 and _within(d0, n) and not bool(flags.any())
              and grade_err <= GRADE_TOL * scale and dev_ok)
        ok_all &= ok
        out[kind] = dict(step0_vs_single=d0, nve_drift_ev_per_atom=drift,
                         final_pos_max_diff=dpos, grade_max_abs_err=grade_err,
                         grade_cancellation_scale=scale,
                         shards_on_every_device=on_all,
                         peak_bytes_per_device=peaks, ok=ok)
    return ok_all, out


# ------------------------------------------------------------------ main


def _gpu_name_and_power():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def _run_phase(name, fn, clock, dev):
    c0, t0 = clock.total, time.perf_counter()
    try:
        ok, info = fn()
    except Exception as e:  # a phase that raises fails; the rest still run
        ok, info = False, dict(error=f"{type(e).__name__}: {e}")
    peak = dev.memory_stats().get("peak_bytes_in_use")
    print(json.dumps(dict(
        phase=name, ok=bool(ok), seconds=round(time.perf_counter() - t0, 3),
        compile_seconds=round(clock.total - c0, 3), peak_bytes_in_use=peak,
        **info,
    ), default=float), flush=True)
    return bool(ok)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded engine on four GPUs and the "
                         "single-device run it is compared with")
    args = ap.parse_args(argv)
    try:
        import jax

        from mtp_jax.utils.cache import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: cannot import the engine ({e}); run it from the "
              "root of a checkout", file=sys.stderr)
        return 2
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform}); "
              "this script runs only on the card", file=sys.stderr)
        return 1
    nd = 4 if args.four else 1
    if len(devices) < nd:
        print(f"chip_smoke: needs {nd} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 1
    jax.config.update("jax_enable_x64", True)  # the float64 references
    cache = enable_compile_cache()
    card = _gpu_name_and_power()
    print(card, flush=True)
    print(f"jax {jax.__version__}; compile cache {cache}", flush=True)
    clock = CompileClock()
    dev = devices[0]
    if args.four:
        big = Size(reps=(63, 63, 63))  # 1,000,188 atoms
        ok = _run_phase("sharded", lambda: phase_sharded(big, nd), clock, dev)
    else:
        size = Size()
        ok = True
        for name, fn in (
            ("force_parity", lambda: phase_force_parity(size)),
            ("md", lambda: phase_md(size)),
            ("active_learning", lambda: phase_active_learning(size)),
            ("exactness", phase_exactness),
        ):
            ok &= _run_phase(name, fn, clock, dev)
    print(card, flush=True)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": nd,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
