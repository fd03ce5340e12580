"""Accuracy gate at bench scale: fp32 (or df32) forces/energy against XLA at
float64 on the same GPU, in the same process.

The f64 oracle chain: utils/golden.py (loop-level reference-spec
transcription) == the XLA f64 path to ~1e-11 at small N (tests/test_model.py,
and chip_smoke.py on the card), so the XLA f64 evaluation is the oracle at
sizes where the Python-loop golden engine is infeasible (32k would take
hours).

Usage (on a GPU; the script refuses to run elsewhere):
    python tools/accuracy_gate.py          # fp32 production path vs f64
    python tools/accuracy_gate.py --df32   # double-float accuracy mode

Prints one JSON line with max|dF|, RMS dF, dE/atom (both the fp32 sum and
the f64 host sum of fp32 site energies), the force scale for context, and
the device it ran on.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CFG = dict(level=16, reps=(20, 20, 20), a=4.0, seed=0)


def _config_positions():
    """The bench config, thermally displaced, deterministically (minted on
    the host, not by running MD).

    Positions/cell are rounded to f32 once here, so the oracle evaluates at
    exactly the configuration the fp32 path sees: the gate measures the
    evaluator's arithmetic error, not the f32 representation error of the
    coordinates (~ulp(80 A) = 8e-6 A)."""
    from mtp_jax.md.simulation import make_lattice

    pos, types, cell = make_lattice("fcc", CFG["a"], CFG["reps"])
    rng = np.random.default_rng(CFG["seed"])
    # ~300 K thermal displacement amplitude for fcc Ni (sigma ~ 0.07 A)
    pos = pos + rng.normal(scale=0.07, size=pos.shape)
    pos = pos.astype(np.float32).astype(np.float64)
    cell = np.asarray(cell, np.float32).astype(np.float64)
    return pos, types, cell


def _evaluate(dtype, backend="xla"):
    """Energy, site energies, forces and virial of the config at `dtype`."""
    import jax.numpy as jnp

    from mtp_jax.io.basis_gen import make_mtp
    from mtp_jax.models.mtp import MTPModel, mtp_energy_forces
    from mtp_jax.ops.neighbors import build_neighbor_list, grid_shape

    m = make_mtp(CFG["level"], species_count=1, seed=CFG["seed"])
    model = MTPModel.from_data(m, dtype=dtype)
    pos, types, cell = _config_positions()
    p, c = jnp.asarray(pos, dtype), jnp.asarray(cell, dtype)
    nl = build_neighbor_list(
        p, c, model.cutoff, max_neighbors=64,
        grid=grid_shape(cell, model.cutoff), with_reverse=True,
    )
    if bool(nl.overflow):
        raise RuntimeError("neighbor overflow at J=64")
    args = (model.schedule, model.coeffs, p, jnp.asarray(types, jnp.int32),
            nl.idx, c, nl.mirror)
    out = mtp_energy_forces(*args, backend=backend)
    res = {k: np.asarray(v, np.float64) for k, v in out.items()}
    return res, args


def _ms_per_eval(args, backend, iters):
    """Force evaluations amortized in one lax.scan (the input is perturbed
    per iteration so XLA cannot hoist the evaluation out of the loop)."""
    import jax
    import jax.numpy as jnp

    from mtp_jax.models.mtp import mtp_energy_forces

    sched, coeffs, pos, types, idx, cell, mirror = args

    def one(x, i):
        o = mtp_energy_forces(sched, coeffs, x + i * jnp.float32(1e-30),
                              types, idx, cell, mirror, backend=backend)
        return x, o["forces"][0, 0]

    @jax.jit
    def loop(x):
        _, ys = jax.lax.scan(one, x, jnp.arange(iters, dtype=jnp.float32))
        return ys.sum()

    float(loop(pos))  # compile + warm
    t0 = time.perf_counter()
    float(loop(pos))
    return (time.perf_counter() - t0) / iters * 1e3


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    import jax

    from mtp_jax.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"accuracy_gate: no GPU (JAX found {dev.platform})",
              file=sys.stderr)
        return 1
    jax.config.update("jax_enable_x64", True)  # the f64 oracle
    enable_compile_cache()
    import jax.numpy as jnp

    ref, _ = _evaluate(jnp.float64)
    df32 = "--df32" in argv
    out, args = _evaluate(jnp.float32, backend="df32" if df32 else "xla")
    n = len(ref["forces"])
    df = out["forces"] - ref["forces"]
    fmag = np.linalg.norm(ref["forces"], axis=1)
    d = dict(
        metric="accuracy-gate (32k level-16 thermal fcc, %s vs XLA f64)"
        % ("df32" if df32 else "fp32"),
        platform=dev.platform, device_kind=dev.device_kind,
        device_count=len(jax.devices()),
        n_atoms=n,
        max_abs_dF=float(np.abs(df).max()),
        rms_dF=float(np.sqrt((df**2).mean())),
        force_scale_rms=float(np.sqrt((fmag**2).mean())),
        dE_per_atom_device_sum=float(abs(out["energy"] - ref["energy"]) / n),
        dE_per_atom_f64_host_sum=float(
            abs(out["site_energies"].sum() - ref["energy"]) / n
        ),
        max_site_e_err=float(
            np.abs(out["site_energies"] - ref["site_energies"]).max()
        ),
        max_dvirial=float(np.abs(out["virial"] - ref["virial"]).max()),
        virial_scale=float(np.abs(ref["virial"]).max()),
    )
    if df32:
        d["df32_ms_per_eval"] = _ms_per_eval(args, "df32", 4)
        d["fp32_ms_per_eval"] = _ms_per_eval(args, "xla", 20)
        d["cost_ratio"] = d["df32_ms_per_eval"] / d["fp32_ms_per_eval"]
    print(json.dumps(d))
    return 0


if __name__ == "__main__":
    sys.exit(main())
