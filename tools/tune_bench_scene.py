"""Tune the bench128 scene toward a bounded, CFL<=1 steady state.

Runs candidate (buoyancy, strength, density_dissipation, velocity_damping)
sets at 128^3 on CPU and prints the displacement/mass trajectory every 50
steps.  The goal: steady-state max backtrace displacement ~0.7-0.9 cells
(the reference's single semi-Lagrangian backtrace is then exact — no CFL
clamping) with mass/velocity plateauing instead of diverging.

JAX_PLATFORMS=cpu python tools/tune_bench_scene.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import fluidsim_tpu as fs
from fluidsim_tpu.models.stable3d import simulate_step_3d
from fluidsim_tpu.scene.sources import apply_custom_source

CANDIDATES = [
    # (buoyancy, strength, k_density, k_velocity)
    (0.2, 20.0, 5.0, 3.0),
    (0.5, 40.0, 5.0, 8.0),
    (1.0, 60.0, 8.0, 12.0),
]

STEPS = 600
CHUNK = 50


def run(buoy, strength, kd, kv) -> None:
    cfg = fs.get_preset("bench128").replace(
        buoyancy=buoy,
        source_strength=strength,
        density_dissipation=kd,
        velocity_damping=kv,
        advect_substeps=1,
    )
    dt = np.float32(cfg.effective_params()[0])
    n = cfg.current_size
    dt0 = dt * (n - 2)
    state = fs.zeros_state(cfg)

    def one(state, _):
        t = state.time + dt
        density, velocity = apply_custom_source(
            state.density, state.velocity, cfg, t
        )
        state = simulate_step_3d(
            state.replace(density=density, velocity=velocity), cfg
        )
        return state, (jnp.abs(state.velocity).max(), state.density.mean())

    @jax.jit
    def rollout(state):
        return jax.lax.scan(one, state, None, length=CHUNK)

    print(f"--- buoy={buoy} strength={strength} kd={kd} kv={kv} "
          f"(dt0={dt0:.2f})", flush=True)
    for k in range(STEPS // CHUNK):
        state, (vmax, dmean) = rollout(state)
        print(
            f"  step {(k + 1) * CHUNK:4d} disp={dt0 * float(vmax.max()):6.3f}"
            f" (end {dt0 * float(vmax[-1]):6.3f})"
            f" mean_rho={float(dmean[-1]):8.3f}",
            flush=True,
        )


if __name__ == "__main__":
    for cand in CANDIDATES:
        run(*cand)
