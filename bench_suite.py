"""Benchmark suite: one JSON line per configuration, on one GPU.

(bench.py is the single-line headline benchmark; this suite is the broader
evidence: parity config, NPT with stress, multi-species, active learning,
and large-system runs.) Refuses to run without a GPU; every line names the
device. Each timed configuration reports the median of three windows.
"""

import dataclasses
import json
import statistics
import sys
import time

import numpy as np

DEVICE = {}


def _jsonline(**kw):
    print(json.dumps({**kw, **DEVICE}), flush=True)


def main():
    import jax

    from mtp_jax.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_suite: no GPU (JAX found {dev.platform})",
              file=sys.stderr)
        return 1
    DEVICE.update(platform=dev.platform, device_kind=dev.device_kind,
                  device_count=len(jax.devices()))
    enable_compile_cache()
    import jax.numpy as jnp

    from mtp_jax.al.grades import candidate_vectors, nbh_grades
    from mtp_jax.al.maxvol import build_mvs
    from mtp_jax.io.basis_gen import make_mtp
    from mtp_jax.md.simulation import Simulation, make_lattice
    from mtp_jax.md.state import init_state, pressure_of, thermalize
    from mtp_jax.models.mtp import MTPModel
    from mtp_jax.ops.neighbors import build_neighbor_list, grid_shape

    _jsonline(protocol="steady-state spb-multiple windows, median of 3")

    def timed(step, repeats=3):
        """Median rate of `repeats` calls of step() -> atom-steps done."""
        rates = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            work = step()
            rates.append(work / (time.perf_counter() - t0))
        return statistics.median(rates)

    def throughput(model, reps, n_steps=100, **run_kw):
        pos, types, cell = make_lattice("fcc", 4.0, reps, **run_kw.pop("lat", {}))
        n = len(pos)
        state = thermalize(
            jax.random.PRNGKey(0),
            init_state(pos, types, np.full(n, 58.693), cell, dtype=jnp.float32),
            300.0,
        )
        sim = Simulation(
            model, max_neighbors=64, skin=0.6, steps_per_rebuild=30,
            compute_virial=run_kw.pop("virial", False),
        )
        ensemble = run_kw.pop("ensemble", "nve")
        # equilibrate through the thermalization transient (its fatter
        # max-displacement tail trips the Verlet staleness flag at spb=30)
        eq = dataclasses.replace(sim, steps_per_rebuild=10)
        state, _, eq_ovf = eq.run_async(state, 60, ensemble="nve", dt=0.001)
        assert not bool(eq_ovf)
        if ensemble == "npt":
            state, aux = sim.run(state, n_steps, ensemble="npt", dt=0.001, **run_kw)
            return state, None
        state, _, overflow = sim.run_async(state, n_steps, ensemble=ensemble, dt=0.001, **run_kw)
        float(jnp.sum(state.positions))
        assert not bool(overflow)
        cur = [state]

        def step():
            cur[0], _, ovf = sim.run_async(cur[0], n_steps, ensemble=ensemble, dt=0.001, **run_kw)
            float(jnp.sum(cur[0].positions))
            assert not bool(ovf)
            return n * n_steps

        return n, timed(step)

    # 1. parity config: 2k-atom fcc, level-8
    model8 = MTPModel.from_data(make_mtp(8, species_count=1, seed=0), dtype=jnp.float32)
    n, v = throughput(model8, (8, 8, 8))
    _jsonline(config="2k-atom level-8 NVE", atoms=n, atom_steps_per_s=round(v, 1))

    # 2. level-16 32k NPT with virial/stress every step.
    # Start near the minted potential's equilibrium density so the barostat
    # rings gently; the static bin grid gets ~15% shrink margin via the
    # coarser grid_shape cutoff inside run_async's rebuild.
    model16 = MTPModel.from_data(make_mtp(16, species_count=1, seed=0), dtype=jnp.float32)
    pos, types, cell = make_lattice("fcc", 3.9, (20, 20, 20))
    state = thermalize(
        jax.random.PRNGKey(1),
        init_state(pos, types, np.full(len(pos), 58.693), cell, dtype=jnp.float32),
        300.0,
    )
    sim = Simulation(model16, max_neighbors=96, skin=0.6, steps_per_rebuild=20,
                     compute_virial=True, grid_margin=1.15)
    eq = dataclasses.replace(sim, steps_per_rebuild=5)
    state, aux, ovf = eq.run_async(state, 30, ensemble="npt", dt=0.001,
                                   temperature=300.0, pressure=0.0,
                                   tdamp=0.1, pdamp=2.0)
    float(jnp.sum(state.positions)); assert not bool(ovf)
    state, aux, ovf = sim.run_async(state, 20, ensemble="npt", dt=0.001,
                                    temperature=300.0, pressure=0.0,
                                    tdamp=0.1, pdamp=2.0, aux=aux)
    float(jnp.sum(state.positions))
    warm_ovf = bool(ovf)
    t0 = time.perf_counter()
    state, aux, ovf = sim.run_async(state, 100, ensemble="npt", dt=0.001,
                                    temperature=300.0, pressure=0.0,
                                    tdamp=0.1, pdamp=2.0, aux=aux)
    float(jnp.sum(state.positions))
    v = len(pos) * 100 / (time.perf_counter() - t0)
    _jsonline(config="32k-atom level-16 NPT (per-step stress)", atoms=len(pos),
              atom_steps_per_s=round(v, 1),
              pressure_bar=round(float(pressure_of(state)), 1),
              overflow=warm_ovf or bool(ovf))

    # 2b. level-16 32k NVT (NHC thermostat in the step scan)
    pos, types, cell = make_lattice("fcc", 4.0, (20, 20, 20))
    state = thermalize(
        jax.random.PRNGKey(5),
        init_state(pos, types, np.full(len(pos), 58.693), cell, dtype=jnp.float32),
        300.0,
    )
    sim = Simulation(model16, max_neighbors=64, skin=0.6, steps_per_rebuild=30,
                     compute_virial=False)
    eq = dataclasses.replace(sim, steps_per_rebuild=10)
    state, _, ovf = eq.run_async(state, 60, ensemble="nve", dt=0.001)
    float(jnp.sum(state.positions)); assert not bool(ovf)
    state, aux, ovf = sim.run_async(state, 100, ensemble="nvt", dt=0.001,
                                    temperature=300.0, tdamp=0.1)
    float(jnp.sum(state.positions)); assert not bool(ovf)
    t0 = time.perf_counter()
    state, aux, ovf = sim.run_async(state, 100, ensemble="nvt", dt=0.001,
                                    temperature=300.0, tdamp=0.1, aux=aux)
    float(jnp.sum(state.positions))
    v = len(pos) * 100 / (time.perf_counter() - t0)
    _jsonline(config="32k-atom level-16 NVT", atoms=len(pos),
              atom_steps_per_s=round(v, 1))

    # 3. binary alloy, per-pair radial coefficients
    model2s = MTPModel.from_data(
        make_mtp(16, species_count=2, seed=1), dtype=jnp.float32
    )
    pos, types, cell = make_lattice("fcc", 4.0, (20, 20, 20), type_pattern=(0, 1))
    state = thermalize(
        jax.random.PRNGKey(2),
        init_state(pos, types, np.where(types == 0, 58.693, 95.95), cell, dtype=jnp.float32),
        300.0,
    )
    sim = Simulation(model2s, max_neighbors=64, skin=0.6, steps_per_rebuild=30,
                     compute_virial=False)
    eq = dataclasses.replace(sim, steps_per_rebuild=10)
    state, _, ovf = eq.run_async(state, 60, ensemble="nve", dt=0.001)
    float(jnp.sum(state.positions)); assert not bool(ovf)
    state, _, ovf = sim.run_async(state, 100, ensemble="nve", dt=0.001)
    float(jnp.sum(state.positions)); assert not bool(ovf)
    t0 = time.perf_counter()
    state, _, ovf = sim.run_async(state, 100, ensemble="nve", dt=0.001)
    float(jnp.sum(state.positions))
    v = len(pos) * 100 / (time.perf_counter() - t0)
    _jsonline(config="32k-atom level-16 binary alloy NVE", atoms=len(pos),
              atom_steps_per_s=round(v, 1))

    # 4. neighborhood-mode active learning
    m8 = make_mtp(8, species_count=1, seed=0)
    model = MTPModel.from_data(m8, dtype=jnp.float32)
    pos, types, cell = make_lattice("fcc", 4.0, (10, 10, 10))
    rng = np.random.default_rng(0)
    rows = []
    for s in (0.02, 0.06, 0.1):
        p = jnp.asarray(pos + rng.normal(scale=s, size=pos.shape), jnp.float32)
        nl = build_neighbor_list(p, jnp.asarray(cell, jnp.float32), model.cutoff,
                                 max_neighbors=64, grid=grid_shape(cell, model.cutoff))
        b, _ = candidate_vectors(model.schedule, model.coeffs, p,
                                 jnp.asarray(types), nl.idx, jnp.asarray(cell, jnp.float32))
        rows.append(np.asarray(b))
    m8.mvs = build_mvs(np.concatenate(rows, 0), mode="neighborhood")
    model = MTPModel.from_data(m8, dtype=jnp.float32)
    p0 = jnp.asarray(pos, jnp.float32)
    nl = build_neighbor_list(p0, jnp.asarray(cell, jnp.float32), model.cutoff,
                             max_neighbors=64, grid=grid_shape(cell, model.cutoff))
    b, _ = candidate_vectors(model.schedule, model.coeffs, p0, jnp.asarray(types),
                             nl.idx, jnp.asarray(cell, jnp.float32))
    g = nbh_grades(b, model.inverse_active_set)
    float(jnp.max(g))
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        b, _ = candidate_vectors(model.schedule, model.coeffs, p0, jnp.asarray(types),
                                 nl.idx, jnp.asarray(cell, jnp.float32))
        g = nbh_grades(b, model.inverse_active_set)
    mg = float(jnp.max(g))
    dt = (time.perf_counter() - t0) / reps
    _jsonline(config="4k-atom neighborhood AL grade eval", atoms=len(pos),
              grade_evals_per_s=round(1 / dt, 2), max_grade=round(mg, 3))

    # 4b. AL fused with MD at bench scale: 32k atoms, level-16, grades every
    # 30 steps through run_with_extrapolation (Verlet-list reuse + shared
    # forward). The marginal AL cost per grade step should be ~one force
    # evaluation (the reference's ComputeAlphaBasicRad economics).
    from mtp_jax.al.driver import ExtrapolationMonitor, run_with_extrapolation

    m16al = make_mtp(16, species_count=1, seed=0)
    pos4, types4, cell4 = make_lattice("fcc", 4.0, (10, 10, 10))
    rng = np.random.default_rng(1)
    rows = []
    for s in (0.02, 0.06, 0.1):
        p = jnp.asarray(pos4 + rng.normal(scale=s, size=pos4.shape), jnp.float32)
        nl4 = build_neighbor_list(
            p, jnp.asarray(cell4, jnp.float32), 5.0,
            max_neighbors=64, grid=grid_shape(cell4, 5.0),
        )
        b4, _ = candidate_vectors(
            MTPModel.from_data(m16al, dtype=jnp.float32).schedule,
            MTPModel.from_data(m16al, dtype=jnp.float32).coeffs,
            p, jnp.asarray(types4), nl4.idx, jnp.asarray(cell4, jnp.float32),
        )
        rows.append(np.asarray(b4))
    m16al.mvs = build_mvs(np.concatenate(rows, 0), mode="neighborhood")
    model_al = MTPModel.from_data(m16al, dtype=jnp.float32)

    pos, types, cell = make_lattice("fcc", 4.0, (20, 20, 20))  # 32k
    n = len(pos)
    state = thermalize(
        jax.random.PRNGKey(5),
        init_state(pos, types, np.full(n, 58.693), cell, dtype=jnp.float32),
        300.0,
    )
    sim = Simulation(model_al, max_neighbors=64, skin=0.6,
                     steps_per_rebuild=30, compute_virial=False)
    eq = dataclasses.replace(sim, steps_per_rebuild=10)
    state, _, fl = eq.run_async(state, 60, ensemble="nve", dt=0.001)
    float(jnp.sum(state.positions)); assert not bool(fl)
    mon = ExtrapolationMonitor(model_al)
    n_steps, al_every = 120, 30
    # warm compile
    state = run_with_extrapolation(sim, mon, state, al_every,
                                   al_every=al_every, ensemble="nve", dt=0.001)
    t0 = time.perf_counter()
    state = run_with_extrapolation(sim, mon, state, n_steps,
                                   al_every=al_every, ensemble="nve", dt=0.001)
    dt_al = time.perf_counter() - t0
    # pure-MD wall time of the same segment for the marginal AL cost
    state2, _, fl = sim.run_async(state, n_steps, ensemble="nve", dt=0.001)
    float(jnp.sum(state2.positions))
    t0 = time.perf_counter()
    state2, _, fl = sim.run_async(state, n_steps, ensemble="nve", dt=0.001)
    float(jnp.sum(state2.positions))
    dt_md = time.perf_counter() - t0
    n_evals = n_steps // al_every + 1
    _jsonline(
        config="32k-atom level-16 AL (grades every 30 steps, fused)",
        atoms=n,
        atom_steps_per_s_with_al=round(n * n_steps / dt_al, 1),
        atom_steps_per_s_pure_md=round(n * n_steps / dt_md, 1),
        ms_per_grade_eval=round((dt_al - dt_md) / n_evals * 1e3, 2),
        max_grade=round(mon.max_grade, 3),
    )

    # 5. large system on one device (the per-device shard size of a
    # multi-device run)
    pos, types, cell = make_lattice("fcc", 4.0, (40, 40, 25))  # 160k atoms
    n = len(pos)
    state = thermalize(
        jax.random.PRNGKey(3),
        init_state(pos, types, np.full(n, 58.693), cell, dtype=jnp.float32),
        300.0,
    )
    eq = Simulation(model16, max_neighbors=64, skin=0.6, steps_per_rebuild=10,
                    compute_virial=False)
    state, _, ovf = eq.run_async(state, 40, ensemble="nve", dt=0.001)
    float(jnp.sum(state.positions)); assert not bool(ovf)
    sim = Simulation(model16, max_neighbors=64, skin=0.6, steps_per_rebuild=30,
                     compute_virial=False)
    # 90 = 3 x steps_per_rebuild: rebuilds amortized at the exact steady-state
    # 1/30-step rate (a 40-step window pays 2 rebuilds = 1/20).
    state, _, ovf = sim.run_async(state, 90, ensemble="nve", dt=0.001)
    float(jnp.sum(state.positions)); assert not bool(ovf)
    cur = [state]

    def step_nve():
        cur[0], _, ovf = sim.run_async(cur[0], 90, ensemble="nve", dt=0.001)
        float(jnp.sum(cur[0].positions))
        assert not bool(ovf)
        return n * 90

    v = timed(step_nve)
    _jsonline(config="160k-atom level-16 NVE (per-device shard scale)", atoms=n,
              atom_steps_per_s=round(v, 1))

    # 6. million-atom box on ONE device
    pos, types, cell = make_lattice("fcc", 4.0, (63, 63, 63))  # 1,000,188
    n = len(pos)
    state = thermalize(
        jax.random.PRNGKey(4),
        init_state(pos, types, np.full(n, 58.693), cell, dtype=jnp.float32),
        300.0,
    )
    eq = Simulation(model16, max_neighbors=64, skin=0.6, steps_per_rebuild=10,
                    compute_virial=False)
    # 60 eq steps: the thermalization transient's max-displacement tail is
    # an extreme-value statistic over 1M atoms; 30 steps intermittently
    # trips the (correctly working) staleness flag.
    state, _, ovf = eq.run_async(state, 60, ensemble="nve", dt=0.001)
    float(jnp.sum(state.positions)); assert not bool(ovf)
    # spb=30: at skin=0.6 a 40-step block trips the (exact top-2)
    # staleness flag on the 1M extreme-value displacement tail, and
    # skin > 0.6 overflows J=64.
    sim = Simulation(model16, max_neighbors=64, skin=0.6, steps_per_rebuild=30,
                     compute_virial=False)
    state, _, ovf = sim.run_async(state, 30, ensemble="nve", dt=0.001)
    float(jnp.sum(state.positions)); assert not bool(ovf)
    # 90 = 3 x steps_per_rebuild: rebuilds at the exact steady-state 1/30
    # rate.
    cur = [state]
    v = timed(step_nve)
    _jsonline(config="1M-atom level-16 NVE (one device)", atoms=n,
              atom_steps_per_s=round(v, 1), overflow=bool(ovf))

    # 6b. 1M NPT with per-step stress, steady state. External pressure set
    # to the system's own instantaneous pressure so the cell only breathes
    # (a 0-bar target from the minted potential's ~-90 kbar start quenches
    # ~2.5%/100 steps and legitimately overflows fixed capacities; run()
    # recovers, but that measures recompile time, not throughput).
    sim_npt = Simulation(model16, max_neighbors=64, skin=0.6,
                         steps_per_rebuild=30, compute_virial=True,
                         grid_margin=1.05)
    grid_1m = grid_shape(np.asarray(jax.device_get(state.cell)),
                         (model16.cutoff + 0.6) * 1.05)
    nl_1m = sim_npt.rebuild(state, grid=grid_1m, max_neighbors=64)
    st_npt = sim_npt.refresh_forces(state, nl_1m, ensemble="npt")
    from mtp_jax.md.state import pressure_of as _p_of

    p0 = float(_p_of(st_npt))
    npt_kw = dict(ensemble="npt", dt=0.001, temperature=300.0, pressure=p0,
                  tdamp=0.1, pdamp=2.0)
    st_npt, aux_npt, ovf = sim_npt.run_async(st_npt, 30, refresh=False,
                                             **npt_kw)
    float(jnp.sum(st_npt.positions)); assert not bool(ovf)
    cur_npt = [st_npt, aux_npt]

    def step_npt():
        cur_npt[0], cur_npt[1], ovf = sim_npt.run_async(
            cur_npt[0], 90, aux=cur_npt[1], refresh=False, **npt_kw)
        float(jnp.sum(cur_npt[0].positions))
        assert not bool(ovf)
        return n * 90

    v = timed(step_npt)
    _jsonline(config="1M-atom level-16 NPT (per-step stress, one device)",
              atoms=n, atom_steps_per_s=round(v, 1),
              pressure_bar=round(p0, 1), overflow=bool(ovf))

    # 7. the sharded engine on a 1-device mesh: the record of the
    # sharded/single-device ratio (the full migration + halo + shard_map
    # pipeline should stay within a few % of the single-device rate; cf.
    # the reference's kernel pipeline unchanged under MPI decomposition,
    # pair_mtp_kokkos.cpp:287-361)
    from mtp_jax.parallel.domain import partition_slabs
    from mtp_jax.parallel.sharded_md import ShardedState, make_mesh
    from mtp_jax.parallel.sharded_window import ShardedSimulation

    def sharded_throughput(reps, n_steps, spb, key):
        pos, types, cell = make_lattice("fcc", 4.0, reps)
        n = len(pos)
        masses = np.full(n, 58.693)
        state = thermalize(
            jax.random.PRNGKey(key),
            init_state(pos, types, masses, cell, dtype=jnp.float32),
            300.0,
        )
        mesh = make_mesh(1)
        part = partition_slabs(
            np.asarray(state.positions), np.asarray(state.velocities),
            types, masses, cell, 1, cutoff=model16.cutoff + 0.6,
            capacity=int(np.ceil((n * 1.05 + 16) / 8) * 8),
        )
        sstate = ShardedState.from_partition(part, cell, mesh, dtype=jnp.float32)
        grid = grid_shape(cell, model16.cutoff + 0.6)
        eq = ShardedSimulation(
            model16, mesh, capacity=part.capacity, max_neighbors=64,
            skin=0.6, steps_per_rebuild=10, grid=grid,
        )
        sstate, flags = eq.run_async(sstate, 60, ensemble="nve", dt=0.001)
        float(jnp.sum(sstate.positions))
        assert not bool(flags.any()), flags
        sim = ShardedSimulation(
            model16, mesh, capacity=part.capacity, max_neighbors=64,
            skin=0.6, steps_per_rebuild=spb, grid=grid,
        )
        sstate, flags = sim.run_async(sstate, n_steps, ensemble="nve", dt=0.001)
        float(jnp.sum(sstate.positions))
        assert not bool(flags.any()), flags
        cur = [sstate]

        def step():
            cur[0], flags = sim.run_async(cur[0], n_steps, ensemble="nve", dt=0.001)
            float(jnp.sum(cur[0].positions))
            assert not bool(flags.any()), flags
            return n * n_steps

        return n, timed(step)

    n, v = sharded_throughput((20, 20, 20), 210, 30, key=6)
    _jsonline(config="32k sharded engine (1-device mesh)", atoms=n,
              atom_steps_per_s=round(v, 1))
    n, v = sharded_throughput((40, 40, 25), 90, 30, key=7)
    _jsonline(config="160k sharded engine (1-device mesh)", atoms=n,
              atom_steps_per_s=round(v, 1))


if __name__ == "__main__":
    sys.exit(main())
