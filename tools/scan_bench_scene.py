"""Scan (time_step, velocity_damping) candidates for the CFL<=1 bench scene.

The steady max backtrace displacement balances buoyancy input against the
implicit damping sink (v_ss ~ buoyancy*rho/k_v), so disp scales ~ dt/k_v.
Measured anchor: (dt=0.002, kv=3) -> steady 1.88 cells, run_max 2.05
(tools/validate_bench_scene.py).  Goal: steady ~0.7-0.9, run_max <= 1.0,
so the reference's single semi-Lagrangian backtrace (n_sub=1, K=1) is
exact — never clamped.

JAX_PLATFORMS=cpu python tools/scan_bench_scene.py
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
    # (time_step, velocity_damping, buoyancy)
    (0.002, 8.0, 0.1),
    (0.002, 8.0, 0.15),
    (0.00125, 8.0, 0.2),
]
BASE = dict(
    source_strength=20.0,
    density_dissipation=5.0,
    advect_substeps=1,
)
STEPS = 900
CHUNK = 100


def run(ts: float, kv: float, buoy: float) -> float:
    cfg = fs.get_preset("bench128").replace(
        time_step=ts, velocity_damping=kv,
        buoyancy=buoy, **BASE
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

    run_max = 0.0
    for k in range(STEPS // CHUNK):
        state, (vmax, dmean) = rollout(state)
        m = dt0 * float(vmax.max())
        run_max = max(run_max, m)
        print(
            f"  dt={ts} kv={kv} b={buoy} step {(k + 1) * CHUNK:4d}"
            f" chunk_max_disp={m:6.3f} (end {dt0 * float(vmax[-1]):6.3f})"
            f" run_max={run_max:6.3f} mean_rho={float(dmean[-1]):8.5f}",
            flush=True,
        )
    return run_max


def main() -> None:
    for ts, kv, buoy in CANDIDATES:
        m = run(ts, kv, buoy)
        verdict = "OK" if m <= 1.0 else "TOO FAST"
        print(f"CANDIDATE dt={ts} kv={kv} b={buoy}: run_max_disp={m:.3f}"
              f" {verdict}", flush=True)


if __name__ == "__main__":
    main()
