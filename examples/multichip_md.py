"""Multi-device MD with the full single-device output surface.

The reference's thermo/dump/AL plumbing is MPI-rank-transparent (LAMMPS
gathers per-atom data and reduces scalars behind the scenes). This example
is the mtp_jax equivalent on a device mesh:

 1. partition an fcc box into slabs over an 8-(virtual-)device mesh,
 2. run NVT blocks on the sharded engine (`ShardedSimulation.run`
    with automatic overflow/staleness recovery),
 3. log thermo rows and dump extended-XYZ frames through the id-ordered
    gather (`gather_md_state`: every single-device writer works unchanged),
 4. monitor extrapolation grades with the rank-local fused AL path
    (`run_sharded_with_extrapolation`), and
 5. checkpoint the gathered state.

Runs on CPU in ~2 min:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/multichip_md.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
import jax

jax.config.update("jax_platforms", os.environ.get("MTP_EXAMPLE_PLATFORM", "cpu"))
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from mtp_jax.al.driver import (
    ShardedExtrapolationMonitor,
    run_sharded_with_extrapolation,
)
from mtp_jax.al.grades import candidate_vectors
from mtp_jax.al.maxvol import build_mvs
from mtp_jax.io.basis_gen import make_mtp
from mtp_jax.md.output import ThermoLogger, XYZDumpWriter, save_checkpoint
from mtp_jax.md.simulation import make_lattice
from mtp_jax.md.state import init_state, thermalize
from mtp_jax.models.mtp import MTPModel
from mtp_jax.ops.neighbors import build_neighbor_list_bruteforce, grid_shape
from mtp_jax.parallel.domain import partition_slabs
from mtp_jax.parallel.observables import (
    gather_md_state,
    sharded_pressure,
    sharded_temperature,
)
from mtp_jax.parallel.sharded_md import ShardedState, make_mesh
from mtp_jax.parallel.sharded_window import ShardedSimulation

N_DEV = 8
SKIN = 0.3

# -- model with an MVS selection state (so grades are available) ------------
m = make_mtp(8, species_count=1, seed=0)
model0 = MTPModel.from_data(m, dtype=jnp.float64)
pos, types, cell = make_lattice("fcc", 4.0, (16, 4, 4))
masses = np.full(len(pos), 58.693)
rng = np.random.default_rng(0)
rows = []
for s in (0.02, 0.08):
    p = pos + rng.normal(scale=s, size=pos.shape)
    nl = build_neighbor_list_bruteforce(
        jnp.asarray(p), jnp.asarray(cell), model0.cutoff, max_neighbors=64
    )
    b, _ = candidate_vectors(
        model0.schedule, model0.coeffs, jnp.asarray(p),
        jnp.asarray(types, jnp.int32), nl.idx, jnp.asarray(cell),
    )
    rows.append(np.asarray(b))
m.mvs = build_mvs(np.concatenate(rows, 0), mode="neighborhood")
model = MTPModel.from_data(m, dtype=jnp.float64)

# -- shard over the mesh -----------------------------------------------------
state0 = thermalize(
    jax.random.PRNGKey(0),
    init_state(pos, types, masses, cell, dtype=jnp.float64),
    300.0,
)
mesh = make_mesh(N_DEV)
part = partition_slabs(
    pos, np.asarray(state0.velocities), types, masses, cell, N_DEV,
    cutoff=model.cutoff + SKIN,
    capacity=int(np.ceil((len(pos) / N_DEV * 1.4 + 16) / 8) * 8),
)
sstate = ShardedState.from_partition(part, cell, mesh, dtype=jnp.float64)
sim = ShardedSimulation(
    model, mesh, capacity=part.capacity, max_neighbors=64,
    grid=grid_shape(cell, model.cutoff + SKIN), skin=SKIN,
    steps_per_rebuild=5, compute_virial=True,
)

# -- NVT with thermo + dump through the id-ordered gather --------------------
thermo = ThermoLogger(
    columns=("step", "temp", "pe", "etotal", "press"), stream=sys.stdout
)
OUT = tempfile.mkdtemp(prefix="multichip_md_")
dump = XYZDumpWriter(os.path.join(OUT, "traj.xyz"), species=("Ni",))
n_done = 0


def observer(s):
    global n_done
    n_done += sim.steps_per_rebuild
    # cheap device-side scalars (no gather): great for high-rate logging
    t_dev = float(sharded_temperature(s, len(pos)))
    p_dev = float(sharded_pressure(s))
    # full single-device output surface via the id-ordered gather
    gst = gather_md_state(s, len(pos), step=n_done)
    thermo(gst)
    dump.write(gst, forces=True)
    assert abs(t_dev - thermo.history[-1]["temp"]) < 1e-6
    assert abs(p_dev - thermo.history[-1]["press"]) < 1e-3


sstate, flags = sim.run(
    sstate, 15, ensemble="nvt", dt=0.001, temperature=300.0, tdamp=0.1,
    observer=observer,
)
assert not bool(flags.any())
dump.close()
print(f"dumped {n_done // sim.steps_per_rebuild} frames -> {OUT}/traj.xyz")

# -- grades on the sharded engine (rank-local fused AL) -----------------------
mon = ShardedExtrapolationMonitor(
    model, mesh, capacity=part.capacity,
    grid=grid_shape(cell, model.cutoff + SKIN), n_atoms=len(pos),
)
sstate = run_sharded_with_extrapolation(
    sim, mon, sstate, 10, al_every=5, ensemble="nvt", dt=0.001,
    temperature=300.0, tdamp=0.1,
)
print(f"max extrapolation grade: {mon.max_grade:.4f} "
      f"(per-atom grades: {len(mon.nbh_grades)})")

# -- checkpoint the gathered state -------------------------------------------
gst = gather_md_state(sstate, len(pos), step=25)
save_checkpoint(os.path.join(OUT, "ckpt.npz"), gst)
print(f"checkpoint -> {OUT}/ckpt.npz")
print("OK")
