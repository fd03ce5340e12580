"""End-to-end MTP workflow: train -> simulate -> actively learn -> retrain.

The complete lifecycle the reference supports only half of (it consumes
MLIP-3-trained potentials; here every stage is in-framework):

 1. label a small training set with a "teacher" (stands in for DFT),
 2. fit MTP coefficients (linear warm start + Adam),
 3. build a MaxVol selection state and write a full .mtp (+MVS trailer),
 4. run NVT MD with MLIP-3-style two-threshold extrapolation monitoring,
 5. read back the preselected configurations (what you would re-label).

Runs on CPU in ~2 minutes:   JAX_PLATFORMS=cpu python examples/full_workflow.py
"""

import os
import tempfile

import jax

# f64 workflow -> CPU (override with MTP_EXAMPLE_PLATFORM=gpu + f32 edits)

jax.config.update("jax_platforms", os.environ.get("MTP_EXAMPLE_PLATFORM", "cpu"))
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

TMP = tempfile.mkdtemp(prefix="full_workflow_")

from mtp_jax.al.driver import (
    BreakThresholdExceeded,
    ExtrapolationMonitor,
    run_with_extrapolation,
)
from mtp_jax.al.grades import candidate_vectors
from mtp_jax.al.maxvol import build_mvs
from mtp_jax.io.basis_gen import make_mtp
from mtp_jax.io.cfg_file import Config, read_cfgs
from mtp_jax.io.mtp_file import save_mtp
from mtp_jax.md.output import ThermoLogger
from mtp_jax.md.simulation import Simulation, make_lattice
from mtp_jax.md.state import init_state, thermalize
from mtp_jax.models.mtp import MTPCoeffs, MTPModel
from mtp_jax.ops.neighbors import build_neighbor_list_bruteforce
from mtp_jax.train.fit import fit, make_dataset
from mtp_jax.utils import golden

rng = np.random.default_rng(0)

# ---- 1. training data from a "teacher" (use golden f64 as the oracle) ----
teacher = make_mtp(8, species_count=1, seed=11)
pos0, types, cell = make_lattice("fcc", 4.0, (3, 3, 3))
configs = []
for k in range(12):
    p = pos0 + rng.normal(scale=0.02 + 0.01 * (k % 6), size=pos0.shape)
    out = golden.compute(teacher, p, types, cell=cell)
    configs.append(
        Config(cell=cell, positions=p, types=types,
               energy=out["energy"], forces=out["forces"])
    )
print(f"[1] labeled {len(configs)} training configurations")

# ---- 2. fit a fresh student potential on that data ----
student_mtp = make_mtp(8, species_count=1, seed=99)  # different random init
student = MTPModel.from_data(student_mtp, dtype=jnp.float64)
data = make_dataset(configs, student.cutoff, max_neighbors=48)
coeffs, losses = fit(student.schedule, student.coeffs, data, steps=150,
                     learning_rate=2e-3, force_weight=0.1)
print(f"[2] fit: loss {losses[0]:.3e} -> {losses[-1]:.3e}")

# ---- 3. MaxVol selection state + a complete .mtp file ----
student_mtp.radial_coeffs = np.asarray(coeffs.radial_coeffs)
student_mtp.species_coeffs = np.asarray(coeffs.species_coeffs)
student_mtp.moment_coeffs = np.asarray(coeffs.moment_coeffs)
rows = []
for c in configs:
    nl = build_neighbor_list_bruteforce(
        jnp.asarray(c.positions), jnp.asarray(c.cell), student.cutoff,
        max_neighbors=48)
    b, _ = candidate_vectors(
        student.schedule, coeffs, jnp.asarray(c.positions),
        jnp.asarray(c.types, jnp.int32), nl.idx, jnp.asarray(c.cell))
    rows.append(np.asarray(b))
student_mtp.mvs = build_mvs(np.concatenate(rows, 0), mode="neighborhood")
save_mtp(os.path.join(TMP, "student.mtp"), student_mtp)
print(f"[3] wrote {TMP}/student.mtp (P={student_mtp.coeff_count}, MVS trailer)")

# ---- 4. MD with MLIP-3-style extrapolation monitoring ----
model = MTPModel.load(os.path.join(TMP, "student.mtp"), dtype=jnp.float64)
state = thermalize(
    jax.random.PRNGKey(1),
    init_state(pos0, types, np.full(len(pos0), 58.693), cell, dtype=jnp.float64),
    600.0,  # hotter than the training set -> expect extrapolation
)
sim = Simulation(model, max_neighbors=48, skin=0.6, steps_per_rebuild=10)
mon = ExtrapolationMonitor(model, select_threshold=2.0, break_threshold=1000.0,
                           output_path=os.path.join(TMP, "preselected.cfg"), max_neighbors=48)
import sys
thermo = ThermoLogger(("step", "temp", "pe", "max_grade"), every=20, stream=sys.stdout)
try:
    state = run_with_extrapolation(
        sim, mon, state, 200, al_every=20, ensemble="nvt", dt=0.002,
        temperature=600.0, tdamp=0.1,
        observer=lambda s, mo: thermo(s, max_grade=mo.max_grade),
    )
    print(f"[4] 200 NVT steps done; final max grade {mon.max_grade:.2f}")
except BreakThresholdExceeded as e:
    print(f"[4] {e}")
finally:
    mon.close()

# ---- 5. harvest the preselected configurations for re-labeling ----
selected = read_cfgs(os.path.join(TMP, "preselected.cfg"))
print(f"[5] {len(selected)} configurations preselected for re-labeling "
      f"(grades > {mon.select_threshold})")
