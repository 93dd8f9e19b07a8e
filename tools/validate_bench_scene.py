"""Validate the retuned CFL-bounded bench scene at 128^3 on CPU.

Long-horizon check that the candidate bench128 parameters keep the max
per-axis backtrace displacement <= 1 cell (so the single-substep
reference backtrace is exact, never clamped) and that mass/velocity
plateau (bounded steady state).

JAX_PLATFORMS=cpu python tools/validate_bench_scene.py [steps]
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

# Candidate scene: tuned via tools/tune_bench_scene.py, then corrected
# against on-chip validation runs.  Measured: (dt=0.002, strength=20)
# steady disp ~1.87 cells, spike 2.051; (dt=0.00085, strength=20)
# steady 1.17, spike 1.214 — NOT linear in dt because the emitter adds
# strength per STEP (the reference's semantics, FluidSim.cs:723-729),
# so smaller dt means a denser, more buoyant plume.  Holding the
# per-time injection fixed (strength ∝ dt) restores linear dt scaling:
# dt=0.0008, strength=8 predicts steady ~0.75, spike ~0.82.
CANDIDATE = dict(
    time_step=0.0008,
    buoyancy=0.2,
    source_strength=8.0,
    density_dissipation=5.0,
    velocity_damping=3.0,
    advect_substeps=1,
)


def main() -> None:
    total = int(sys.argv[1]) if len(sys.argv) > 1 else 1500
    chunk = 100
    cfg = fs.get_preset("bench128").replace(**CANDIDATE)
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
        return jax.lax.scan(one, state, None, length=chunk)

    run_max = 0.0
    for k in range(total // chunk):
        state, (vmax, dmean) = rollout(state)
        m = dt0 * float(vmax.max())
        run_max = max(run_max, m)
        print(
            f"step {(k + 1) * chunk:5d} chunk_max_disp={m:6.3f}"
            f" (end {dt0 * float(vmax[-1]):6.3f})"
            f" run_max={run_max:6.3f}"
            f" mean_rho={float(dmean[-1]):9.5f}",
            flush=True,
        )
    ok = run_max <= 1.0
    print(f"FINAL run_max_disp={run_max:.3f} cells "
          f"{'OK (n_sub=1 exact, never clamped)' if ok else 'TOO FAST'}")


if __name__ == "__main__":
    main()
