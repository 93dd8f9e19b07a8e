"""bench128 on one GPU: steps/s and p50 step+raymarch frame time.

    python bench.py

Both numbers run the engine's own jitted step (``Engine``: emitter +
solver step) on the bench128 preset (128³, 60-iteration Jacobi
projection).

* steps/s — ``SUBSTEPS``-step ``lax.scan`` dispatches, ``TRIALS`` timed
  samples after a compile + warm-up dispatch; reports the median sample,
  with the spread.
* p50 step+raymarch — one jitted program per frame (step, then the
  volumetric render of the new state), dispatched and synchronized frame
  by frame as a live viewer would; the median over ``FRAMES`` frames.

Prints one JSON line naming the device.  Exits non-zero without a result
when JAX finds no GPU: a CPU number is never reported as this benchmark.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

PRESET = "bench128"
SUBSTEPS = 100
TRIALS = 10
FRAMES = 200


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX's default device is {dev.platform!r})",
              file=sys.stderr)
        return 1

    from fluidsim_tpu.config import get_preset
    from fluidsim_tpu.engine import Engine
    from fluidsim_tpu.render.raymarch import render_frame_3d
    from fluidsim_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cfg = get_preset(PRESET)
    eng = Engine(cfg)

    t0 = time.perf_counter()
    eng.step(SUBSTEPS, substeps_per_dispatch=SUBSTEPS)
    jax.block_until_ready(eng.state)
    setup_s = time.perf_counter() - t0
    samples = []
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        eng.step(SUBSTEPS, substeps_per_dispatch=SUBSTEPS)
        jax.block_until_ready(eng.state)
        samples.append(SUBSTEPS / (time.perf_counter() - t0))

    step = eng._fused_step(1)

    @jax.jit
    def frame(state, src):
        state = step(state, src)
        return state, render_frame_3d(state, cfg)

    state, src = eng.state, eng._src_params
    state, img = jax.block_until_ready(frame(state, src))  # compile
    frame_ms = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        state, img = jax.block_until_ready(frame(state, src))
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    if not (bool(jax.numpy.isfinite(state.density).all())
            and bool(jax.numpy.isfinite(img).all())):
        print("bench: non-finite state or frame", file=sys.stderr)
        return 1

    print(json.dumps({
        "metric": f"steps/s ({PRESET}, 128^3, 60-iter Jacobi)",
        "value": float(np.median(samples)),
        "unit": "steps/s",
        "spread": [float(min(samples)), float(max(samples))],
        "samples": TRIALS,
        "steps_per_sample": SUBSTEPS,
        "p50_step_raymarch_ms": float(np.percentile(frame_ms, 50)),
        "setup_s": setup_s,
        "peak_bytes_in_use": int(
            (dev.memory_stats() or {}).get("peak_bytes_in_use", -1)),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
