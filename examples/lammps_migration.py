"""The reference README's example LAMMPS script, translated line by line.

The reference ships one smoke input (README.md:124-147): a bcc potassium
box, every pair-style variant selectable by uncommenting, `velocity
create`, `fix nve`, `run 100`. This is the same workflow through mtp_jax —
each LAMMPS command is quoted above its equivalent, including the
`mtp/extrapolation <file> <out.cfg> <select> <break>` variant and a
`read_data`/`write_data` round trip.

Runs on CPU in ~2 min:  JAX_PLATFORMS=cpu python examples/lammps_migration.py
On a GPU it is the same code with dtype=jnp.float32.
"""

import os
import tempfile

import jax

jax.config.update("jax_platforms", os.environ.get("MTP_EXAMPLE_PLATFORM", "cpu"))
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

TMP = tempfile.mkdtemp(prefix="lammps_migration_")

from mtp_jax.al.driver import (
    BreakThresholdExceeded,
    ExtrapolationMonitor,
    run_with_extrapolation,
)
from mtp_jax.al.grades import candidate_vectors
from mtp_jax.al.maxvol import build_mvs
from mtp_jax.io.basis_gen import make_mtp
from mtp_jax.io.lammps_data import read_lammps_data, write_lammps_data
from mtp_jax.io.mtp_file import save_mtp
from mtp_jax.md.output import ThermoLogger
from mtp_jax.md.simulation import Simulation, make_lattice
from mtp_jax.md.state import init_state, temperature_of, thermalize
from mtp_jax.models.mtp import MTPModel
from mtp_jax.ops.neighbors import build_neighbor_list_bruteforce

DT = 0.001  # `units metal`: ps, A, eV (the framework's native units)

# -- the reference needs an MLIP-3-trained potential file; we mint a
#    potassium-shaped one (bcc a=5.28 -> first neighbor 4.57 A) so the
#    example is self-contained. A real .mtp from MLIP-3 loads the same way.
mtp_path = os.path.join(TMP, "potassium_demo.mtp")
mdata = make_mtp(8, species_count=1, seed=0,
                 min_dist=2.4, max_dist=6.0, r0=4.57, well_depth=0.05)
save_mtp(mtp_path, mdata)

# lattice         bcc 5.28
# region          box block 0 3 0 3 0 3 units lattice
# create_box      1 box
# create_atoms    1 region box
pos, types, cell = make_lattice("bcc", 5.28, (3, 3, 3))

# mass 1 39.0983
masses = np.full(len(pos), 39.0983)

# pair_style mtp path/to/mtp/file        (mtp/kk: same engine, GPU path)
# pair_coeff * *                         (not required -- nor here)
model = MTPModel.load(mtp_path, dtype=jnp.float64)
sim = Simulation(model, max_neighbors=40, skin=0.6, steps_per_rebuild=10)

# run 0  (LAMMPS computes initial forces/energy)
state = init_state(pos, types, masses, cell, dtype=jnp.float64)
nl = sim.rebuild(state, grid=(2, 2, 2), max_neighbors=40)
state = sim.refresh_forces(state, nl)
print(f"run 0: PE = {float(state.potential_energy):.6f} eV")

# velocity all create 200.0 12345 mom yes rot yes
state = thermalize(jax.random.PRNGKey(12345), state, 200.0)

# fix 1 all nve
# thermo 10
# run 100
thermo = ThermoLogger(columns=("step", "temp", "pe", "etotal"), every=10)
state, _ = sim.run(state, 100, ensemble="nve", dt=DT, observer=thermo)
print(f"after 100 NVE steps: T = {float(temperature_of(state)):.1f} K")

# write_data box.data  /  read_data box.data (migrate existing LAMMPS boxes)
write_lammps_data(os.path.join(TMP, "potassium.data"), np.asarray(state.positions), types,
                  masses, np.asarray(cell),
                  velocities=np.asarray(state.velocities))
d = read_lammps_data(os.path.join(TMP, "potassium.data"))
print(f"data-file round trip: {len(d.positions)} atoms, "
      f"{d.type_masses[0]:.4f} amu")

# pair_style mtp/extrapolation path/to/mtp ./pre.cfg 10 10
#   (select_threshold=10, break_threshold=10; grades need an MVS selection
#    state -- MLIP-3 ships it in the .mtp trailer, here MaxVol builds it)
rng = np.random.default_rng(0)
train_pool = []
for _ in range(8):
    p = pos + rng.normal(0, 0.15, pos.shape)
    nlb = build_neighbor_list_bruteforce(
        jnp.asarray(p), jnp.asarray(cell), model.cutoff, max_neighbors=40)
    b, _ = candidate_vectors(model.schedule, model.coeffs, jnp.asarray(p),
                             jnp.asarray(types), nlb.idx, jnp.asarray(cell))
    train_pool.append(np.asarray(b))
mdata.mvs = build_mvs(np.concatenate(train_pool))
save_mtp(mtp_path, mdata)
model_al = MTPModel.load(mtp_path, dtype=jnp.float64)

sim_al = Simulation(model_al, max_neighbors=40, skin=0.6, steps_per_rebuild=10)
monitor = ExtrapolationMonitor(
    model_al, select_threshold=2.0, break_threshold=10.0,
    output_path=os.path.join(TMP, "pre.cfg"), max_neighbors=40,
)
# fix pair 10 ... extrapolation 1  +  thermo_style custom step c_max_grade[1]
try:
    state2 = run_with_extrapolation(
        sim_al, monitor, state, 50, al_every=10, ensemble="nve", dt=DT)
    print(f"AL run: final max grade {float(monitor.max_grade):.3f}")
except BreakThresholdExceeded as e:
    # LAMMPS `fix halt` analog: stream flushed before the break
    print(f"break threshold hit: {e}")
finally:
    monitor.close()
n_sel = sum(1 for line in open(os.path.join(TMP, "pre.cfg")) if line.startswith("BEGIN_CFG"))
print(f"{n_sel} preselected configuration(s) -> {TMP}/pre.cfg")
