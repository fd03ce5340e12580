"""Validating production fp32 MD against the df32 reference-grade evaluator.

The reference computes everything in f64 (pair_mtp.cpp throughout); users
coming from it often spot-check forces/energies against MLIP-3. This
framework's equivalent workflow: run MD on the fp32 fast path, and
re-evaluate snapshots with the df32 (double-float) backend: the same
model, the same neighbor list, ~49-bit arithmetic from f32 operations.

Run (CPU, ~2 min):
    PYTHONPATH=. python examples/accuracy_validation.py

On a GPU the same script validates the production path end-to-end.
"""

import os
import tempfile

# the df32 graphs hit a pathological LLVM path in XLA:CPU's new fusion
# emitters (see ops/moments_df.py); a CPU-only flag
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_cpu_use_fusion_emitters=false"
)

import jax
import jax.numpy as jnp
import numpy as np

TMP = tempfile.mkdtemp(prefix="accuracy_validation_")

from mtp_jax.io.basis_gen import make_mtp
from mtp_jax.io.mtp_file import save_mtp
from mtp_jax.md.simulation import Simulation, make_lattice
from mtp_jax.md.state import init_state, thermalize
from mtp_jax.models.mtp import MTPModel
from mtp_jax.ops.neighbors import grid_shape


def main():
    # mint a level-12 potential (or MTPModel.load("your.mtp"))
    save_mtp(os.path.join(TMP, "val.mtp"), make_mtp(12, species_count=1, seed=0))
    model = MTPModel.load(os.path.join(TMP, "val.mtp"), dtype=jnp.float32)

    pos, types, cell = make_lattice("fcc", 4.0, (5, 5, 5))
    n = len(pos)
    state = thermalize(
        jax.random.PRNGKey(0),
        init_state(pos, types, np.full(n, 58.693), cell, dtype=jnp.float32),
        300.0,
    )

    # production MD on the fast path
    sim = Simulation(model, max_neighbors=64, skin=0.5, steps_per_rebuild=10)
    state, _ = sim.run(state, 100, ensemble="nve", dt=0.001)

    # reference-grade re-evaluation of the evolved snapshot: same model,
    # same frozen neighbor list, df32 arithmetic
    grid = grid_shape(np.asarray(state.cell), model.cutoff + 0.5)
    prod = Simulation(model, max_neighbors=64, skin=0.5)
    acc = Simulation(model, max_neighbors=64, skin=0.5,
                     backend="df32")
    nl_p = prod.rebuild(state, grid=grid, max_neighbors=64)
    nl_a = acc.rebuild(state, grid=grid, max_neighbors=64)
    f_prod = np.asarray(prod.refresh_forces(state, nl_p).forces, np.float64)
    out_acc = acc.refresh_forces(state, nl_a)
    f_acc = np.asarray(out_acc.forces, np.float64)

    df = np.abs(f_prod - f_acc)
    scale = np.sqrt((f_acc**2).sum(axis=1)).mean()
    print(f"production-vs-df32 after 100 steps ({n} atoms):")
    print(f"  max |dF|  = {df.max():.3e} eV/A   (RMS force scale {scale:.3f})")
    print(f"  RMS dF    = {np.sqrt((df**2).mean()):.3e} eV/A")
    print(f"  PE (df32) = {float(out_acc.potential_energy):.6f} eV")
    # the fp32 fast path stays within its documented envelope (~1e-4
    # relative max at bench scale, PARITY.md §2)
    assert df.max() < 5e-4 * max(scale, 1.0)
    print("OK: production forces within the documented fp32 envelope")


if __name__ == "__main__":
    main()
