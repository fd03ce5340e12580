"""Observables, trajectory dumps, thermo logging, checkpoint/resume.

The reference exposes observables through LAMMPS plumbing: scalar max grade
via `compute pair` (pvector, pair_mtp_extrapolation.cpp:42-44, 381), per-atom
arrays via `fix pair` + `dump` (…:641-652), thermo via `thermo_style`.
Checkpointing is positions/velocities/box only (`restartinfo = 0`,
pair_mtp.cpp:38 — model files are immutable inputs). These are the framework
equivalents.
"""

from __future__ import annotations


import pickle
from typing import IO, Optional, Sequence

import jax
import numpy as np

from mtp_jax.md.state import (
    MDState,
    kinetic_energy,
    pressure_of,
    temperature_of,
    volume_of,
)


class ThermoLogger:
    """Tabular thermo output (the `thermo_style custom ...` analog)."""

    COLUMNS = {
        "step": lambda s, ex: int(s.step),
        "temp": lambda s, ex: float(temperature_of(s)),
        "pe": lambda s, ex: float(s.potential_energy),
        "ke": lambda s, ex: float(kinetic_energy(s)),
        "etotal": lambda s, ex: float(s.potential_energy + kinetic_energy(s)),
        "press": lambda s, ex: float(pressure_of(s)),
        "vol": lambda s, ex: float(volume_of(s)),
        "max_grade": lambda s, ex: ex.get("max_grade", float("nan")),
    }

    def __init__(
        self,
        columns: Sequence[str] = ("step", "temp", "pe", "etotal", "press"),
        every: int = 1,
        stream: Optional[IO] = None,
    ):
        unknown = set(columns) - set(self.COLUMNS)
        if unknown:
            raise ValueError(f"unknown thermo columns: {unknown}")
        self.columns = list(columns)
        self.every = every
        self.stream = stream
        self.history: list[dict] = []
        self._header_done = False

    def __call__(self, state: MDState, **extras):
        if int(state.step) % self.every:
            return
        row = {c: self.COLUMNS[c](state, extras) for c in self.columns}
        self.history.append(row)
        if self.stream is not None:
            if not self._header_done:
                self.stream.write(
                    " ".join(f"{c:>14s}" for c in self.columns) + "\n"
                )
                self._header_done = True
            self.stream.write(
                " ".join(
                    f"{row[c]:14d}" if c == "step" else f"{row[c]:14.6g}"
                    for c in self.columns
                )
                + "\n"
            )
            self.stream.flush()

    def column(self, name):
        return np.array([r[name] for r in self.history])


class XYZDumpWriter:
    """Extended-XYZ trajectory writer (the `dump custom` analog); optional
    per-atom arrays (forces, grades) become extra columns."""

    def __init__(self, path: str, species: Optional[Sequence[str]] = None):
        self._f = open(path, "w")
        self.species = species

    def write(self, state: MDState, *, grades=None, forces: bool = False):
        pos = np.asarray(state.positions)
        types = np.asarray(state.types)
        cell = np.asarray(state.cell)
        n = len(pos)
        props = "species:S:1:pos:R:3"
        if forces:
            props += ":forces:R:3"
        if grades is not None:
            props += ":nbh_grade:R:1"
        lattice = " ".join(f"{v:.8f}" for v in cell.reshape(-1))
        self._f.write(f"{n}\n")
        self._f.write(
            f'Lattice="{lattice}" Properties={props} '
            f"step={int(state.step)} energy={float(state.potential_energy):.8f}\n"
        )
        f_arr = np.asarray(state.forces)
        for i in range(n):
            sp = (
                self.species[types[i]]
                if self.species is not None
                else f"T{types[i]}"
            )
            row = f"{sp} {pos[i, 0]:.8f} {pos[i, 1]:.8f} {pos[i, 2]:.8f}"
            if forces:
                row += f" {f_arr[i, 0]:.8f} {f_arr[i, 1]:.8f} {f_arr[i, 2]:.8f}"
            if grades is not None:
                row += f" {float(grades[i]):.6f}"
            self._f.write(row + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_checkpoint(path: str, state: MDState, aux=None) -> None:
    """Checkpoint = dynamical state only (positions/velocities/cell/step +
    integrator aux). The model is re-read from its .mtp file on resume,
    mirroring the reference's restart contract."""
    payload = {
        "positions": np.asarray(state.positions),
        "velocities": np.asarray(state.velocities),
        "forces": np.asarray(state.forces),
        "masses": np.asarray(state.masses),
        "types": np.asarray(state.types),
        "cell": np.asarray(state.cell),
        "potential_energy": np.asarray(state.potential_energy),
        "virial": np.asarray(state.virial),
        "step": np.asarray(state.step),
    }
    if aux is not None:
        leaves, treedef = jax.tree.flatten(aux)
        payload["aux_count"] = np.asarray(len(leaves))
        for k, leaf in enumerate(leaves):
            payload[f"aux_leaf_{k}"] = np.asarray(leaf)
        payload["aux_treedef"] = np.frombuffer(
            pickle.dumps(treedef), dtype=np.uint8
        )
    np.savez(path, **payload)


def load_checkpoint(path: str, dtype=None):
    """Returns (MDState, aux or None)."""
    import jax.numpy as jnp

    with np.load(path, allow_pickle=True) as z:
        cast = (lambda a: jnp.asarray(a, dtype)) if dtype else jnp.asarray
        state = MDState(
            positions=cast(z["positions"]),
            velocities=cast(z["velocities"]),
            forces=cast(z["forces"]),
            masses=cast(z["masses"]),
            types=jnp.asarray(z["types"]),
            cell=cast(z["cell"]),
            potential_energy=cast(z["potential_energy"]),
            virial=cast(z["virial"]),
            step=jnp.asarray(z["step"]),
        )
        aux = None
        if "aux_treedef" in z:
            treedef = pickle.loads(z["aux_treedef"].tobytes())
            leaves = [
                jnp.asarray(z[f"aux_leaf_{k}"]) for k in range(int(z["aux_count"]))
            ]
            aux = jax.tree.unflatten(treedef, leaves)
    return state, aux
