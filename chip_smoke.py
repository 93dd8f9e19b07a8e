#!/usr/bin/env python3
"""Smoke test: the fluid engine's main path on NVIDIA GPUs.

Run from the root of a checkout:

    python chip_smoke.py            # one GPU: every preset at full size
    python chip_smoke.py --multi    # four GPUs: sharded512 over a mesh

Everything runs in this one process; it starts no other JAX process.
Phases:

1. device — JAX must find a GPU.  Prints the device kind and count and
   nvidia-smi's name and power limit for each card.
2. main path — each preset is built through ``Engine`` at its full size
   and stepped: one single-step dispatch, then scanned multi-step
   dispatches.  ``cli run`` on bench128 and ``cli render`` on multi256
   run in-process.  Prints steps/s (compile excluded, printed apart),
   peak device memory and a finite check per preset.
3. correctness — each preset's jitted step on the GPU against the same
   jitted step on the CPU backend, from the same state; the NumPy oracles
   (tests/oracle2d.py, tests/oracle3d.py) for one scene_a step at 192²
   and for the projection and gather advection at 128³.
4. ``--multi`` — sharded512 on a 4-device mesh with ``halo="auto"`` and
   ``halo="explicit"``, each against the single-device step from the
   same state; checks that every device holds one slab.  No other
   phase runs.

Any failure raises: the exit code is then non-zero and no result line is
printed.  The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Numbers printed here are smoke numbers, not benchmark cells.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

PRESETS = ("scene_a", "smoke32", "plume64", "vortex128", "bench128",
           "multi256", "sharded512")

# -- tolerances: max|a − b| / max|b| for each field -----------------------
#
# GPU vs CPU runs one XLA program on two backends.  Each compared step
# starts both from the same state (the CPU's previous output), so chaotic
# growth across steps stays out of the number.  The step has no matrix
# product (so no TF32) and no cross-cell reduction, so the backends differ
# only by FMA contraction and the last bits of sqrt, sin, exp and
# division.  How far such last-bit differences move one step's output
# depends on the state: a steep density gradient turns a last-bit change
# of the velocity into a visible density change.  So the tolerance is
# measured on the state itself: the same step on the card from the start
# state with every float field moved by −1, 0 or +1 ulp (seeded) gives
# the step's ulp response, and the CPU may differ from the card by at most
# ULP_FACTOR times that (never less than TOL_BACKEND_MIN).  Rounding
# differs at every operation inside the step, not only at its input; on
# the CPU, op-by-op execution against the fused program (another rounding
# of the same step) differed by at most 2.8× the ulp response at 64³
# (bench128 pressure), so 10 leaves room.
ULP_FACTOR = 10.0
TOL_BACKEND_MIN = 1e-5
# Sharded vs one device: the same backend and the same arithmetic per
# cell; only constant folding of the emitter parameters may differ.
TOL_SHARDED = 1e-5
# The oracles are independent NumPy float32 transcriptions of the same
# formulas in the same order, so the differences are again contraction
# and rounding, about one ulp per operation.  One projection (20 Jacobi
# sweeps, a contraction) or one gather advection agrees to 1e-6 on the
# CPU (tests/test_oracle3d_parity.py); 1e-5 allows for the card's
# contraction.  The 2D scene_a step runs ~160 sweeps and 3 advections
# and agrees to 2e-6 of scale on the CPU (tests/test_parity_step.py);
# 2e-5 allows for the card.
TOL_ORACLE_OP = 1e-5
TOL_ORACLE_STEP = 2e-5

STEPS_PER_DISPATCH = 4
# Phase 3 starts from the state after this many steps, whatever the card's
# speed, so its errors are the same on every run.
DEVELOP_STEPS = 33


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    """A failed check: raise (exit non-zero, no result line)."""
    if not ok:
        raise RuntimeError(msg)


# ----------------------------------------------------------------------
# phase 1: device
# ----------------------------------------------------------------------

def device_phase(min_count: int = 1):
    """Fail unless JAX's default devices are GPUs; print what they are."""
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU — JAX's default device is {d.platform!r} "
            f"({d.device_kind})"
        )
    if len(devs) < min_count:
        raise SystemExit(
            f"chip_smoke: needs {min_count} GPUs, JAX found {len(devs)}"
        )
    log(f"device: platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    log("nvidia-smi --query-gpu=name,power.limit:")
    for line in smi.stdout.strip().splitlines():
        log(line.strip())
    return devs


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------

def preset_config(name: str, size=None):
    """The preset at its full size, or cut to ``size`` cells per axis."""
    from fluidsim_tpu.config import get_preset

    cfg = get_preset(name)
    if size is not None:
        cfg = cfg.replace(size=size, resolution_multiplier=1.0)
    return cfg


def check_finite(name: str, state, cfg) -> float:
    """No NaN/Inf in any field; density mean > 0 while an emitter runs."""
    import jax.numpy as jnp

    finite = all(bool(jnp.isfinite(x).all())
                 for x in (state.density, state.velocity, state.pressure))
    mean = float(state.density.mean())
    require(finite, f"{name}: non-finite field")
    require(mean > 0.0 or not cfg.enable_custom_source,
            f"{name}: density mean {mean} with emitter on")
    return mean


def rel_error(got, ref):
    """(max|got − ref|, that over max|ref|), in float64 on the host."""
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    max_abs = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    return max_abs, max_abs / scale if scale > 0 else max_abs


def compare(label: str, pairs, tol: float, note: str = "") -> None:
    """Print and check each ``(field, got, ref)``: relative error ≤ tol."""
    for field, got, ref in pairs:
        max_abs, rel = rel_error(got, ref)
        ok = rel <= tol
        log(f"check {label} {field}: max_abs={max_abs:.3e} rel={rel:.3e} "
            f"tol={tol:.2e}{note} {'ok' if ok else 'FAIL'}")
        require(ok, f"{label} {field}: rel {rel:.3e} > tol {tol:.2e}")


def perturb_ulp(host):
    """``host`` (a state on the host) with every float32 field array moved
    by −1, 0 or +1 ulp per cell, from a fixed seed."""
    import jax
    import numpy as np

    rng = np.random.default_rng(0)
    step = np.float32(2.0 ** -23)

    def one(x):
        x = np.asarray(x)
        if x.dtype != np.float32 or x.ndim == 0:
            return x
        u = rng.integers(-1, 2, x.shape, dtype=np.int8).astype(np.float32)
        return x * (np.float32(1.0) + u * step)

    return jax.tree_util.tree_map(one, host)


def peak_bytes(device) -> int:
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


# ----------------------------------------------------------------------
# phase 2: main path
# ----------------------------------------------------------------------

def main_path(name: str, size=None, min_seconds: float = 1.0):
    """Build ``name`` through ``Engine``, step it, time it, check it.
    Returns the engine and its state after ``DEVELOP_STEPS`` steps (the
    start of phase 3)."""
    import jax

    from fluidsim_tpu.engine import Engine

    cfg = preset_config(name, size)
    k = STEPS_PER_DISPATCH
    eng = Engine(cfg)
    t0 = time.perf_counter()
    eng.step(1)
    jax.block_until_ready(eng.state)
    eng.step(k, substeps_per_dispatch=k)
    jax.block_until_ready(eng.state)
    first_s = time.perf_counter() - t0
    eng.step(DEVELOP_STEPS - 1 - k, substeps_per_dispatch=k)
    start = jax.block_until_ready(eng.state)  # out of the timed window

    n = 0
    t0 = time.perf_counter()
    while True:
        for _ in range(2):
            eng.step(k, substeps_per_dispatch=k)
        jax.block_until_ready(eng.state)
        n += 2 * k
        elapsed = time.perf_counter() - t0
        if elapsed >= min_seconds:
            break
    mean = check_finite(name, eng.state, cfg)
    extra = ""
    if name == "multi256":
        from fluidsim_tpu.render.raymarch import render_frame_3d

        t0 = time.perf_counter()
        frame = jax.block_until_ready(
            jax.jit(lambda s: render_frame_3d(s, cfg))(eng.state))
        render_s = time.perf_counter() - t0
        require(frame.shape[:2] == cfg.grid_shape[1:],
                f"frame shape {frame.shape}")
        require(bool(jax.numpy.isfinite(frame).all()), "non-finite frame")
        extra = (f" frame={'x'.join(map(str, frame.shape))} "
                 f"render_first_call_s={render_s:.2f}")
    log(f"main {name}: grid={'x'.join(map(str, cfg.grid_shape))} "
        f"steps_per_s={n / elapsed:.2f} ({n} steps, {k}/dispatch, "
        f"{elapsed:.2f} s) first_calls_s={first_s:.2f} "
        f"(compile + {1 + k} steps) "
        f"peak_bytes_in_use={peak_bytes(eng.state.density.devices().pop())} "
        f"density_mean={mean:.6g} finite=yes{extra}")
    return eng, start


def _cli(argv) -> dict:
    """Run ``cli.main(argv)`` in this process; return its JSON line."""
    from fluidsim_tpu import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def cli_phase(size=None) -> None:
    """``cli run`` on bench128 and ``cli render`` on multi256, in-process."""
    sz = [] if size is None else ["--size", str(size)]
    argv = ["run", "--preset", "bench128", "--steps", "20"] + sz
    res = _cli(argv)
    log(f"cli {' '.join(argv)}: {json.dumps(res)}")
    require(res["steps"] == 20, f"cli run: {res}")
    with tempfile.TemporaryDirectory() as outdir:
        argv = ["render", "--preset", "multi256", "--steps", "10",
                "--render-every", "5", "-o", outdir] + sz
        res = _cli(argv)
        log(f"cli render --preset multi256 --steps 10 --render-every 5: "
            f"frames={res['frames']} shape={res['shape']}")
        require(res["frames"] == 2 and len(os.listdir(outdir)) == 2,
                f"cli render: {res}")


# ----------------------------------------------------------------------
# phase 3: correctness
# ----------------------------------------------------------------------

def compare_backends(name: str, eng, start, n_steps: int) -> None:
    """The engine's own jitted step on its device and on the CPU backend,
    ``n_steps`` times from ``start``; each step starts both from the
    CPU's last state."""
    import jax

    cpu = jax.devices("cpu")[0]
    dev = start.density.devices().pop()
    step = eng._fused_step(1)
    src_dev = jax.device_put(eng._src_params, dev)
    src_cpu = jax.device_put(eng._src_params, cpu)
    host = jax.device_get(start)
    for k in range(n_steps):
        out_dev = jax.device_get(step(jax.device_put(host, dev), src_dev))
        out_ulp = jax.device_get(
            step(jax.device_put(perturb_ulp(host), dev), src_dev))
        out_cpu = jax.device_get(step(jax.device_put(host, cpu), src_cpu))
        for f in ("density", "velocity", "pressure"):
            ulp = rel_error(getattr(out_ulp, f), getattr(out_dev, f))[1]
            compare(f"{name} {dev.platform}-vs-cpu step {k + 1}/{n_steps}",
                    [(f, getattr(out_dev, f), getattr(out_cpu, f))],
                    max(TOL_BACKEND_MIN, ULP_FACTOR * ulp),
                    note=f" (ulp_response={ulp:.3e})")
        host = out_cpu


def compare_oracle_2d(eng, start) -> None:
    """One scene_a step against tests/oracle2d.py from ``start``."""
    import jax.numpy as jnp
    import numpy as np

    import oracle2d
    from fluidsim_tpu.models.stable2d import make_step_2d

    cfg = eng.cfg
    obst = np.asarray(start.obstacles)
    d = np.array(start.density, np.float32)
    vx = np.array(start.velocity[0], np.float32)
    vy = np.array(start.velocity[1], np.float32)
    t = np.float32(start.time) + np.float32(cfg.effective_params()[0])
    oracle2d.custom_source(d, vx, vy, cfg, t)
    state = start.replace(density=jnp.asarray(d),
                              velocity=jnp.stack([jnp.asarray(vx),
                                                  jnp.asarray(vy)]))
    got = make_step_2d(cfg)(state)
    od, ovx, ovy, op = oracle2d.simulate_step(d, vx, vy, obst, cfg)
    compare(f"scene_a vs oracle2d one step {cfg.current_size}^2",
            [("density", got.density, od),
             ("vel_x", got.velocity[0], ovx),
             ("vel_y", got.velocity[1], ovy),
             ("pressure", got.pressure, op)],
            TOL_ORACLE_STEP)


def compare_oracle_3d(n: int = 128) -> None:
    """``project_3d`` and the gather ``advect_3d`` at ``n``³ against
    tests/oracle3d.py, with and without a solid sphere."""
    import jax
    import numpy as np

    import oracle3d
    from fluidsim_tpu.ops.advect import advect_3d
    from fluidsim_tpu.ops.project import project_3d

    rng = np.random.default_rng(0)

    def field(b, scale):
        x = rng.standard_normal((n, n, n)).astype(np.float32) * scale
        return oracle3d.set_bnd_3d(b, x, None)

    g = np.mgrid[0:n, 0:n, 0:n]
    sphere = sum((g[i] - n / 2) ** 2 for i in range(3)) <= (n / 10) ** 2
    vel = np.stack([field(b, 0.5) for b in (1, 2, 3)])
    d0 = np.abs(field(0, 3.0))
    vadv = np.stack([field(b, 0.3) for b in (1, 2, 3)])
    # ``None`` is an empty pytree: passed for ``o`` it traces the
    # obstacle-free specialization.
    proj = jax.jit(lambda v, o: project_3d(v, o, iters=20))
    adv = jax.jit(lambda d, v, o: advect_3d(0, d, v, 0.05, o, window=0))
    for obst in (None, sphere):
        tag = "sphere" if obst is not None else "free"
        got_v, got_p = proj(vel, obst)
        got_d = adv(d0, vadv, obst)
        exp_v, exp_p = oracle3d.project_3d(vel, obst, iters=20)
        compare(f"project_3d vs oracle3d {n}^3 {tag}",
                [("velocity", got_v, exp_v), ("pressure", got_p, exp_p)],
                TOL_ORACLE_OP)
        exp_d = oracle3d.advect_3d(0, d0, vadv, 0.05, obst, window=0)
        compare(f"advect_3d gather vs oracle3d {n}^3 {tag}",
                [("density", got_d, exp_d)], TOL_ORACLE_OP)


def check_preset(name: str, size=None, min_seconds: float = 1.0) -> None:
    """Phases 2 and 3 for one preset."""
    eng, start = main_path(name, size, min_seconds)
    n_steps = 3 if eng.cfg.current_size <= 128 else 1
    t0 = time.perf_counter()
    compare_backends(name, eng, start, n_steps)
    if name == "scene_a":
        compare_oracle_2d(eng, start)
    log(f"checked {name} in {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------------
# phase 4: --multi
# ----------------------------------------------------------------------

def multi_phase(devices, size=None, halos=("auto", "explicit"),
                warm_steps: int = 4) -> None:
    """sharded512 over ``devices`` against the single-device step."""
    import jax

    from fluidsim_tpu.engine import Engine
    from fluidsim_tpu.parallel.sharding import (
        make_mesh,
        shard_state,
        sharded_step_fn,
    )

    cfg = preset_config("sharded512", size)
    n = cfg.current_size
    eng = Engine(cfg)
    eng.step(warm_steps)  # single-step dispatches: one compiled program
    start = jax.block_until_ready(eng.state)
    ref = jax.device_get(eng._fused_step(1)(start, eng._src_params))
    mesh = make_mesh(devices)
    want = {(d, (n // len(devices), n, n)) for d in devices}
    for halo in halos:
        step = sharded_step_fn(cfg, mesh, halo=halo)
        sharded = shard_state(start, mesh)
        t0 = time.perf_counter()
        out = jax.block_until_ready(step(sharded))
        first_s = time.perf_counter() - t0
        for label, st in (("input", sharded), ("output", out)):
            held = {(s.device, s.data.shape)
                    for s in st.density.addressable_shards}
            require(held == want, f"{halo} {label} shards: {held}")
        log(f"multi {halo}: {len(devices)} devices each hold one "
            f"{n // len(devices)}x{n}x{n} slab "
            f"({', '.join(str(d.id) for d in devices)}); "
            f"first_call_s={first_s:.2f}")
        compare(f"sharded512 {halo} x{len(devices)} vs 1 device",
                [(f, getattr(out, f), getattr(ref, f))
                 for f in ("density", "velocity", "pressure")],
                TOL_SHARDED)
        t0 = time.perf_counter()
        for _ in range(3):
            out = step(out)
        jax.block_until_ready(out)
        log(f"multi {halo}: steps_per_s={3 / (time.perf_counter() - t0):.3f}"
            f" (3 steps)")


# ----------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="sharded512 on a 4-GPU mesh (auto and explicit "
                   "halo) against one GPU; no other phase runs")
    args = p.parse_args(argv)

    # The CPU backend is the second opinion of phase 3; keep it available
    # when the caller narrowed the platforms (before JAX starts).
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    devs = device_phase(min_count=4 if args.multi else 1)

    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from fluidsim_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    t_all = time.perf_counter()
    if args.multi:
        multi_phase(devs[:4])
    else:
        for name in PRESETS:
            check_preset(name)
        cli_phase()
        compare_oracle_3d(128)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
