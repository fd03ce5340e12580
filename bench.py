"""Headline benchmark: atom-steps/s on one GPU.

Config: 32k-atom bulk fcc, level-16 MTP, J = 64, NVE, fp32. Refuses to run
without a GPU. Prints ONE JSON line naming the device it ran on.
"""

import json
import statistics
import sys
import time

import numpy as np


def main():
    import jax

    from mtp_jax.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX found {dev.platform})", file=sys.stderr)
        return 1
    enable_compile_cache()
    import jax.numpy as jnp

    from mtp_jax.io.basis_gen import make_mtp
    from mtp_jax.md.simulation import Simulation, make_lattice
    from mtp_jax.md.state import init_state, thermalize
    from mtp_jax.models.mtp import MTPModel

    m = make_mtp(16, species_count=1, seed=0)
    model = MTPModel.from_data(m, dtype=jnp.float32)

    pos, types, cell = make_lattice("fcc", 4.0, (20, 20, 20))  # 32000 atoms
    n = len(pos)
    masses = np.full(n, 58.693)
    state = init_state(pos, types, masses, cell, dtype=jnp.float32)
    state = thermalize(jax.random.PRNGKey(0), state, 300.0)

    # skin=0.6: the Verlet staleness check flags any atom moving > skin/2
    # between rebuilds; at 300 K the max 30-step displacement over 32k
    # atoms is ~0.24 A, right at a 0.5-skin's threshold, so 0.6 gives margin.
    sim = Simulation(
        model, max_neighbors=64, skin=0.6, steps_per_rebuild=30,
        compute_virial=False,
    )

    # 210 = exactly 7 x steps_per_rebuild: the timed window pays rebuilds at
    # precisely the steady-state 1/30-step rate (a non-multiple window adds a
    # partial block with an extra rebuild + an extra compiled program).
    n_steps = 210

    # equilibrate through the thermalization transient with short rebuild
    # intervals: right after thermalize the max-displacement tail is fatter
    # and can trip the Verlet staleness flag at steps_per_rebuild=30
    eq = Simulation(
        model, max_neighbors=64, skin=0.6, steps_per_rebuild=10,
        compute_virial=False,
    )
    state, _, eq_flags = eq.run_async(state, 60, ensemble="nve", dt=0.001)
    if bool(eq_flags):
        raise RuntimeError(f"equilibration tripped: {eq_flags}")

    def run(state):
        state, _, flags = sim.run_async(state, n_steps, ensemble="nve", dt=0.001)
        jax.block_until_ready(state.positions)
        if bool(flags):
            raise RuntimeError(f"run tripped: {flags}")
        return state

    state = run(state)  # warm-up with the timed shape (one compile)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        state = run(state)
        times.append(time.perf_counter() - t0)

    rates = [n * n_steps / t for t in times]
    print(
        json.dumps(
            {
                "metric": "atom-steps/s (32k-atom level-16 MTP, NVE, fp32)",
                "value": statistics.median(rates),
                "unit": "atom-steps/s",
                "runs": rates,
                "platform": dev.platform,
                "device_kind": dev.device_kind,
                "device_count": len(jax.devices()),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
