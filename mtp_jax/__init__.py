"""mtp_jax — a JAX Moment Tensor Potential molecular dynamics engine.

A from-scratch JAX/XLA framework with the capabilities of the reference
LAMMPS MTP package (RichardZJM/lammps-mtp-kokkos): MLIP-3-compatible MTP
inference, MaxVol active learning, and the host-engine services the reference
delegates to LAMMPS (neighbor lists, integrators, domain decomposition, I/O).

Subpackages
-----------
io        ``.mtp`` / ``.cfg`` file formats, MTP basis-set generation
models    the MTP model: parameters, schedules, energy/force evaluation
ops       compute primitives: Chebyshev basis, moments, neighbor lists, df32
md        integrators (NVE/NVT/NPT/Langevin) and the simulation driver
al        active learning: MaxVol extrapolation grades, selection, break semantics
parallel  device-mesh sharding: slab/brick decomposition, halo exchange
utils     units, golden reference engine, profiling helpers
"""

from mtp_jax.models.mtp import (  # noqa: F401
    MTPModel,
    MTPCoeffs,
    MTPSchedule,
    mtp_energy,
    mtp_energy_forces,
)
from mtp_jax.io.mtp_file import load_mtp, save_mtp  # noqa: F401

__version__ = "0.1.0"
