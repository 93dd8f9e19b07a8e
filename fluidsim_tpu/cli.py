"""Command-line entry points — the L5/L6 replacement (SURVEY.md §7.9).

The reference's interaction/UI layers are a Unity scene and a UI-Toolkit
menu (MainMenuEvents.cs; Enter / Quit / Save-config buttons).  The
equivalents here:

    python -m fluidsim_tpu.cli run      --preset scene_a --steps 500
    python -m fluidsim_tpu.cli bench    --preset bench128 --steps 100
    python -m fluidsim_tpu.cli render   --preset multi256 --steps 200 -o out
    python -m fluidsim_tpu.cli save-config --preset scene_a -o cfg.json
    python -m fluidsim_tpu.cli presets

``run`` logs metrics to the SQLite store (the Save button's
``SaveCurrentConfiguration`` is the ``save-config`` command); ``render``
writes PNG/NPY frames via the on-device render path.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _build_cfg(args):
    from .config import get_preset
    from .io.checkpoint import load_config

    if args.config:
        cfg = load_config(args.config)
    else:
        cfg = get_preset(args.preset)
    if args.size:
        cfg = cfg.replace(size=args.size)
    if getattr(args, "dtype", None):
        cfg = cfg.replace(dtype=args.dtype)
    if getattr(args, "advect_substeps", None):
        cfg = cfg.replace(advection_scheme="substep",
                          advect_substeps=args.advect_substeps)
    if getattr(args, "pulse_clock", None):
        cfg = cfg.replace(pulse_clock=args.pulse_clock)
    return cfg


def _build_engine(args, store=None):
    from .engine import Engine

    return Engine(_build_cfg(args), store=store, nan_guard=args.nan_guard)


def cmd_run(args):
    from .metrics import MetricsStore

    import jax

    store = MetricsStore(args.db) if args.db else None
    eng = _build_engine(args, store=store)
    from .utils.profiling import StepTimer

    timer = StepTimer()
    per = max(args.substeps, 1)
    done = 0
    sample_steps = []
    while done < args.steps:
        n = min(per, args.steps - done)
        with timer:
            eng.step(n, substeps_per_dispatch=n)
            # Dispatches pipeline (the engine does not sync); time real
            # device completion.
            jax.block_until_ready(eng.state)
        sample_steps.append(n)
        done += n
    summary = timer.summary(steps_per_sample=sample_steps)
    if args.checkpoint:
        eng.save_checkpoint(args.checkpoint)
    print(json.dumps({
        "preset": args.preset,
        "grid": list(eng.cfg.grid_shape),
        "steps": int(eng.state.step),
        "run_id": eng.run_id,
        **summary,
    }))


def _bench_sharded(args):
    """steps/sec for a slab-sharded step over an N-device mesh (BASELINE
    config 5's measurement path: ``bench --preset sharded512 --mesh 4``).

    Runs on whatever devices are visible: N GPUs, or an emulated mesh
    (``XLA_FLAGS=--xla_force_host_platform_device_count=N`` +
    ``JAX_PLATFORMS=cpu``) for correctness runs — the same virtual-mesh
    rig as tests/conftest.py (SURVEY.md §4).
    """
    import jax

    from . import state as fstate
    from .parallel.sharding import make_mesh, shard_state, sharded_step_fn
    from .scene.obstacles import build_obstacle_mask

    cfg = _build_cfg(args)
    devs = jax.devices()
    if len(devs) < args.mesh:
        print(json.dumps({
            "error": f"{args.mesh} devices requested, {len(devs)} visible "
                     "(emulate with XLA_FLAGS="
                     "--xla_force_host_platform_device_count=N "
                     "JAX_PLATFORMS=cpu)",
        }))
        return 1
    mesh = make_mesh(devs[:args.mesh])
    obst = None
    if cfg.enable_obstacle:
        import jax.numpy as jnp

        obst = jnp.asarray(build_obstacle_mask(cfg))
    state = shard_state(fstate.zeros_state(cfg, obstacles=obst), mesh)
    per = max(args.substeps, 1)
    step = sharded_step_fn(
        cfg, mesh, n_substeps=per, halo=args.halo,
        halo_block_iters=args.halo_block_iters,
    )
    state = jax.block_until_ready(step(state))  # compile + warm
    from .utils.profiling import StepTimer

    timer = StepTimer()
    done = 0
    while done < args.steps:
        with timer:
            state = jax.block_until_ready(step(state))
        done += per
    print(json.dumps({
        "preset": args.preset,
        "grid": list(cfg.grid_shape),
        "mesh": args.mesh,
        "halo": args.halo,
        "halo_block_iters": args.halo_block_iters,
        "platform": devs[0].platform,
        **timer.summary(steps_per_sample=per),
    }))
    return 0


def cmd_bench(args):
    args.db = None
    args.nan_guard = False
    if getattr(args, "mesh", None):
        return _bench_sharded(args)
    import contextlib

    import jax

    from .utils.profiling import StepTimer, trace_profile

    eng = _build_engine(args)
    per = max(args.substeps, 1)
    eng.step(per, substeps_per_dispatch=per)  # compile + warm
    jax.block_until_ready(eng.state)  # keep warmup out of sample 1

    timer = StepTimer()
    ctx = trace_profile(args.profile) if args.profile else contextlib.nullcontext()
    with ctx:
        done = 0
        while done < args.steps:
            with timer:
                eng.step(per, substeps_per_dispatch=per)
                # Engine does not sync per dispatch, so the bench must.
                jax.block_until_ready(eng.state)
            done += per
    print(json.dumps({
        "preset": args.preset,
        "grid": list(eng.cfg.grid_shape),
        "profile": args.profile,
        **timer.summary(steps_per_sample=per),
    }))


def cmd_render(args):
    eng = _build_engine(args)
    os.makedirs(args.outdir, exist_ok=True)
    frames = []
    stride = max(args.render_every, 1)
    for i in range(args.steps // stride):
        eng.step(stride, substeps_per_dispatch=stride)
        frame = _render(eng)
        frames.append(frame)
        _write_frame(frame, os.path.join(args.outdir, f"frame_{i:05d}"))
    html = None
    if args.html:
        from .render.viewer import export_html

        html = export_html(
            frames, os.path.join(args.outdir, "index.html"),
            title=f"{args.preset} ({eng.cfg.current_size}^{eng.cfg.ndim})",
        )
    print(json.dumps({
        "frames": len(frames),
        "outdir": args.outdir,
        "html": html,
        "shape": list(frames[-1].shape) if frames else None,
    }))


def _render(eng):
    if eng.cfg.ndim == 3:
        from .render.raymarch import render_frame_3d

        return np.asarray(render_frame_3d(eng.state, eng.cfg))
    from .render.colormap import render_frame_2d
    from .render.streamlines import (
        compute_streamline_segments,
        rasterize_streamlines,
    )

    frame = render_frame_2d(
        eng.state.density, eng.state.pressure, eng.state.obstacles, eng.cfg,
        elapsed_time=float(eng.state.time),
    )
    from .config import ColorMode

    if eng.cfg.show_streamlines or eng.cfg.color_mode == ColorMode.STREAMLINES:
        segs = compute_streamline_segments(
            eng.state.velocity[0], eng.state.velocity[1],
            eng.state.obstacles, eng.cfg,
        )
        return rasterize_streamlines(segs, eng.cfg,
                                     base_frame=np.asarray(frame))
    return np.asarray(frame)


def _write_frame(frame, path):
    arr = np.clip(np.asarray(frame, np.float32), 0.0, 1.0)
    try:
        from PIL import Image  # optional

        img = (arr[::-1] * 255).astype(np.uint8)  # grid y-up → image y-down
        if img.shape[-1] == 3:
            Image.fromarray(img, "RGB").save(path + ".png")
        else:
            Image.fromarray(img, "RGBA").save(path + ".png")
    except ImportError:
        np.save(path + ".npy", arr)


def cmd_save_config(args):
    from .config import get_preset
    from .io.checkpoint import save_config
    from .metrics import MetricsStore

    cfg = get_preset(args.preset)
    if args.out:
        save_config(args.out, cfg)
    run_id = -1
    if args.db:
        with MetricsStore(args.db) as store:
            run_id = store.save_run_params(cfg)
    print(json.dumps({"preset": args.preset, "out": args.out,
                      "run_id": run_id}))


def cmd_serve(args):
    from .metrics import MetricsStore

    args.nan_guard = False
    store = MetricsStore(args.db) if args.db else None
    eng = _build_engine(args, store=store)
    from .render.live import LiveServer

    LiveServer(eng, port=args.port,
               steps_per_frame=args.steps_per_frame).serve_forever()


def cmd_presets(args):
    from .config import PRESETS

    for name in sorted(PRESETS):
        cfg = PRESETS[name]()
        print(f"{name:12s} ndim={cfg.ndim} grid={cfg.grid_shape} "
              f"dt={cfg.time_step} jacobi={cfg.jacobi_iters}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="fluidsim_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, steps=100):
        sp.add_argument("--preset", default="smoke32")
        sp.add_argument("--config", default=None,
                        help="JSON config file (overrides --preset)")
        sp.add_argument("--size", type=int, default=None)
        sp.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default=None, help="field storage dtype override")
        sp.add_argument("--advect-substeps", type=int, default=None,
                        help="override the 3D substepped-advection count "
                        "(n_sub=1 is the reference's single backtrace; "
                        "exact while the CFL displacement stays <= "
                        "n_sub cells — see tools/cfl_probe.py)")
        sp.add_argument("--steps", type=int, default=steps)
        sp.add_argument("--substeps", type=int, default=10,
                        help="steps per lax.scan dispatch")

    sp = sub.add_parser("run", help="run a simulation, log metrics")
    common(sp)
    sp.add_argument("--db", default=None, help="SQLite metrics db path")
    sp.add_argument("--checkpoint", default=None, help="save .npz at end")
    sp.add_argument("--nan-guard", action="store_true")
    sp.set_defaults(fn=cmd_run)

    sp = sub.add_parser("bench", help="steady-state steps/sec")
    common(sp)
    sp.add_argument("--profile", default=None,
                    help="write a jax.profiler trace to this directory")
    sp.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="bench the slab-sharded step over an N-device "
                    "mesh (BASELINE config 5: "
                    "`bench --preset sharded512 --mesh 4`; emulate "
                    "devices with XLA_FLAGS="
                    "--xla_force_host_platform_device_count=N "
                    "JAX_PLATFORMS=cpu)")
    sp.add_argument("--halo", choices=("auto", "explicit"), default="auto",
                    help="stencil-communication strategy for --mesh "
                    "(auto = XLA-partitioned, explicit = shard_map + "
                    "ppermute)")
    sp.add_argument("--halo-block-iters", type=int, default=1, metavar="T",
                    help="communication-avoiding exchange cadence for "
                    "--halo explicit (T-deep halos every T sweeps)")
    # Long rollouts amortize the per-dispatch host cost at small grids;
    # steps rise with them so the default run still collects 10 samples.
    sp.set_defaults(fn=cmd_bench, substeps=100, steps=1000)

    sp = sub.add_parser("render", help="run + write frames")
    common(sp, steps=100)
    sp.add_argument("--outdir", "-o", default="frames")
    sp.add_argument("--render-every", type=int, default=5)
    sp.add_argument("--html", action="store_true",
                    help="write a standalone HTML player (index.html)")
    sp.add_argument("--db", default=None)
    sp.add_argument("--nan-guard", action="store_true")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("save-config", help="persist a config (Save button)")
    sp.add_argument("--preset", default="scene_b")
    sp.add_argument("--out", "-o", default=None)
    sp.add_argument("--db", default=None)
    sp.set_defaults(fn=cmd_save_config)

    sp = sub.add_parser("serve", help="live interactive viewer (browser)")
    sp.add_argument("--preset", default="scene_a")
    sp.add_argument("--config", default=None)
    sp.add_argument("--size", type=int, default=None)
    sp.add_argument("--port", type=int, default=8800)
    sp.add_argument("--steps-per-frame", type=int, default=2)
    sp.add_argument("--db", default=None,
                    help="SQLite store: the viewer's 's' (save config) "
                    "writes a SimulationRuns row here")
    # The interactive viewer defaults to the reference's wall-clock pulse
    # (elapsedTime, FluidSim.cs:394); "sim" gives deterministic pulsing.
    sp.add_argument("--pulse-clock", choices=("sim", "wall"), default="wall")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("presets", help="list presets")
    sp.set_defaults(fn=cmd_presets)

    args = p.parse_args(argv)
    if args.fn is not cmd_presets:  # presets never touches the device
        from .utils.compile_cache import enable_compile_cache

        enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
