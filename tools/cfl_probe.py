"""Measure the advection CFL trajectory of a preset on CPU.

Usage:  JAX_PLATFORMS=cpu python tools/cfl_probe.py \
            [preset] [steps]

Reports, every 100 steps, the running max of the per-axis backtrace
displacement in cells for a FULL dt (``dt0 * max|v_axis|``).  The K=1
two-tap advect kernel clamps per-substep displacement to 1 cell, so

  * max_disp <= 1      -> a single substep (n_sub=1) is exact: identical
                          to the reference's single semi-Lagrangian
                          backtrace (FluidSim.cs:1125-1186), no clamping.
  * 1 < max_disp <= 2  -> n_sub=2 covers the envelope without clamping.
  * max_disp > n_sub   -> the scheme clamps (CFL-limited, still stable).

The CFL trajectory is a property of the physics, so the CPU gives the
same answer as the GPU.
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


def main() -> None:
    preset = sys.argv[1] if len(sys.argv) > 1 else "bench128"
    total = int(sys.argv[2]) if len(sys.argv) > 2 else 3000
    chunk = 100

    cfg = fs.get_preset(preset)
    dt = np.float32(cfg.effective_params()[0])
    n = cfg.current_size
    # ops/advect.py backtrace scale for one full dt.
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
        # Max per-axis displacement (cells) a full-dt backtrace would take
        # from the post-step velocity (what the NEXT step's advect sees).
        disp = dt0 * jnp.max(jnp.abs(state.velocity))
        return state, disp

    @jax.jit
    def rollout(state):
        return jax.lax.scan(one, state, None, length=chunk)

    run_max = 0.0
    for k in range(total // chunk):
        state, disps = rollout(state)
        m = float(disps.max())
        run_max = max(run_max, m)
        print(
            f"step {(k + 1) * chunk:5d}  chunk_max_disp={m:7.3f} cells"
            f"  running_max={run_max:7.3f}"
            f"  max|v|={float(jnp.abs(state.velocity).max()):.4f}",
            flush=True,
        )
    print(f"FINAL preset={preset} steps={total} max_disp={run_max:.3f} "
          f"(n_sub=1 exact iff <=1; current n_sub={cfg.advect_substeps})")


if __name__ == "__main__":
    main()
