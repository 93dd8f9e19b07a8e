"""Engine driver, metrics store, and checkpoint tests."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from fluidsim_tpu.config import SimConfig, ObstacleShape
from fluidsim_tpu.engine import Engine
from fluidsim_tpu.metrics import FrameRateTracker, MetricsStore
from fluidsim_tpu.io.checkpoint import (
    load_checkpoint,
    load_config,
    save_checkpoint,
    save_config,
)


def tiny_cfg(**kw):
    base = dict(
        size=32,
        time_step=0.05,
        enable_custom_source=True,
        source_strength=50.0,
        source_radius=2.0,
        source_position=(0.3, 0.5),
        enable_obstacle=False,
        obstacle_position=(0.5, 0.5),
        logging_interval=2,
    )
    base.update(kw)
    return SimConfig(**base)


def test_engine_runs_and_pauses():
    eng = Engine(tiny_cfg())
    eng.step(3)
    assert int(eng.state.step) == 3
    assert float(eng.state.density.mean()) > 0
    eng.set_paused(True)
    eng.step(5)
    assert int(eng.state.step) == 3
    eng.set_paused(False)
    eng.step(1)
    assert int(eng.state.step) == 4


@pytest.mark.slow  # >30 s solo; the fast tier keeps sibling coverage
def test_engine_host_step_counter_tracks_device():
    """_after_dispatch must not fetch the device step scalar (a device
    sync per dispatch); the host counter it uses instead has to
    agree with the device count across mixed dispatch sizes, resets, and
    checkpoint restore."""
    eng = Engine(tiny_cfg())
    eng.step(5, substeps_per_dispatch=2)  # 2+2+1 remainder path
    assert eng._host_step == int(eng.state.step) == 5
    eng.reset()
    assert eng._host_step == int(eng.state.step) == 0
    eng.step(3, substeps_per_dispatch=3)
    assert eng._host_step == int(eng.state.step) == 3
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck.npz")
        eng.save_checkpoint(path)
        eng2 = Engine.from_checkpoint(path)
        assert eng2._host_step == int(eng2.state.step) == 3
        eng2.step(2)
        assert eng2._host_step == int(eng2.state.step) == 5


def test_engine_scan_rollout_matches_loop():
    e1 = Engine(tiny_cfg())
    e2 = Engine(tiny_cfg())
    e1.step(6, substeps_per_dispatch=1)
    e2.step(6, substeps_per_dispatch=3)
    np.testing.assert_allclose(
        np.asarray(e1.state.density), np.asarray(e2.state.density),
        rtol=1e-5, atol=1e-5,
    )


def test_engine_interaction():
    eng = Engine(tiny_cfg(enable_custom_source=False))
    assert float(jnp.abs(eng.state.velocity).max()) == 0.0
    eng.drag((8.0, 16.0), (14.0, 16.0))
    assert float(jnp.abs(eng.state.velocity).max()) > 0.0
    # source reposition API (FluidSim.cs:979-988)
    eng.set_source_position(16.0, 24.0)
    assert eng.get_source_position() == (16.0, 24.0)


@pytest.mark.slow  # >30 s solo; the fast tier keeps sibling coverage
def test_source_reposition_does_not_retrace():
    """Emitter values are traced operands: shift-drag
    repositioning (FluidSim.cs:397-402) must not recompile the step."""
    eng = Engine(tiny_cfg())
    eng.step(2)
    stepper = eng._fused_step(1)
    before = stepper._cache_size()
    assert before >= 1
    for i in range(4):
        eng.set_source_position(8.0 + 2 * i, 16.0)
        eng.step(1)
    assert stepper._cache_size() == before
    # and the move actually changes where density lands
    eng2 = Engine(tiny_cfg())
    eng2.set_source_position(26.0, 26.0)
    eng2.step(3)
    d = np.asarray(eng2.state.density)
    assert d[20:, 20:].sum() > d[:12, :12].sum()


@pytest.mark.slow  # >30 s solo; the fast tier keeps sibling coverage
def test_wall_clock_pulse():
    """pulse_clock="wall" drives the pulse from accumulated wall-clock
    frame deltas while unpaused (elapsedTime, FluidSim.cs:394,492-494),
    fed as a traced operand (no retrace per frame)."""
    cfg = tiny_cfg(source_pulsing=True, source_pulse_rate=1.0,
                   time_step=1e-4, pulse_clock="wall")
    eng = Engine(cfg)
    fake = iter([0.0, 0.25, 0.5])  # deltas: 0 (first call), then 0.25 each
    eng._clock = lambda: next(fake)
    eng.step(1)            # elapsed 0.0   -> |sin(0)| = 0, no injection
    d_after_first = float(jnp.sum(eng.state.density))
    assert d_after_first == 0.0
    eng.step(1)            # elapsed 0.25  -> |sin(.25π)| ≈ 0.707
    d1 = float(jnp.sum(eng.state.density))
    assert d1 > 0.0
    eng.step(1)            # elapsed 0.50  -> |sin(.5π)| = 1 (peak)
    d2 = float(jnp.sum(eng.state.density))
    # second injection is stronger than the first (0.707 vs 1.0 scale)
    assert (d2 - d1) > d1 * 1.2
    # sim clock with the same tiny dt would have injected ~nothing
    eng_sim = Engine(cfg.replace(pulse_clock="sim"))
    eng_sim.step(3)
    assert float(jnp.sum(eng_sim.state.density)) < d1 * 0.1
    # wall-clock phase is a traced operand: stepping never retraces
    stepper = eng._fused_step(1)
    before = stepper._cache_size()
    eng._clock = __import__("time").perf_counter
    eng.step(3)
    assert stepper._cache_size() == before


def test_wall_clock_pause_excluded():
    """Paused frames do not advance elapsedTime (FluidSim.cs:392-394)."""
    cfg = tiny_cfg(source_pulsing=True, pulse_clock="wall")
    eng = Engine(cfg)
    t = {"now": 0.0}
    eng._clock = lambda: t["now"]
    eng.step(1)
    t["now"] = 1.0
    eng.set_paused(True)
    eng.step(5)            # paused: no sim, no elapsed accumulation
    t["now"] = 9.0
    eng.set_paused(False)  # resume drops the pause gap
    eng.step(1)
    assert eng._elapsed == 0.0
    t["now"] = 9.25
    eng.step(1)
    assert abs(eng._elapsed - 0.25) < 1e-9


def test_wall_clock_delta_clamped():
    """A host hitch advances elapsedTime by at most Unity's Maximum
    Allowed Timestep (ProjectSettings/TimeManager.asset: 0.33333334)."""
    cfg = tiny_cfg(source_pulsing=True, pulse_clock="wall")
    eng = Engine(cfg)
    t = {"now": 0.0}
    eng._clock = lambda: t["now"]
    eng.step(1)
    t["now"] = 5.0         # 5 s hitch → clamped to one max timestep
    eng.step(1)
    assert abs(eng._elapsed - 0.33333334) < 1e-9


def test_engine_reset_on_resize():
    eng = Engine(tiny_cfg())
    eng.step(2)
    eng.set_config(tiny_cfg(size=48))
    assert eng.state.density.shape == (48, 48)
    assert int(eng.state.step) == 0


def test_metrics_store_roundtrip(tmp_path):
    db = str(tmp_path / "test.db")
    with MetricsStore(db) as store:
        # velocity emission on — rows with MaxVelocityMagnitude == 0 are
        # skipped (FluidSim.cs:597 parity, test below)
        eng = Engine(
            tiny_cfg(source_emits_velocity=True, source_velocity=8.0),
            store=store,
        )
        assert eng.run_id > 0
        eng.step(6)
        rows = store.fetch_metrics(eng.run_id)
        assert len(rows) >= 2
        for step, avg, vmax, fps in rows:
            assert avg > 0 and vmax > 0


def test_metrics_store_default_timestep_guard(tmp_path):
    """SQL.cs:53-56: the float32-0.1 default timestep refuses to save."""
    db = str(tmp_path / "test.db")
    with MetricsStore(db) as store:
        assert store.save_run_params(tiny_cfg(time_step=0.1)) == -1
        assert store.save_run_params(tiny_cfg(time_step=0.05)) > 0


def test_metrics_skips_zero_rows(tmp_path):
    """FluidSim.cs:597: rows with zero metrics are skipped."""
    db = str(tmp_path / "t.db")
    with MetricsStore(db) as store:
        rid = store.save_run_params(tiny_cfg())
        store.log_runtime_metrics(rid, 1, 0.0, 5.0, 60.0)
        store.log_runtime_metrics(rid, 2, 3.0, 5.0, 60.0)
        assert len(store.fetch_metrics(rid)) == 1


def test_framerate_ema():
    fr = FrameRateTracker()
    fr.tick(now=0.0)
    # constant 100 FPS frames: EMA approaches 100 from 0 with α=0.9
    vals = [fr.tick(now=0.01 * (i + 1)) for i in range(50)]
    assert vals[0] == pytest.approx(10.0, rel=1e-6)  # 0.9*0 + 0.1*100
    assert vals[-1] > 99.0


@pytest.mark.slow  # >30 s solo; the fast tier keeps sibling coverage
def test_checkpoint_roundtrip(tmp_path):
    eng = Engine(tiny_cfg(enable_obstacle=True,
                          obstacle_shape=ObstacleShape.CIRCLE))
    eng.step(3)
    path = str(tmp_path / "ckpt.npz")
    eng.save_checkpoint(path)
    eng2 = Engine.from_checkpoint(path)
    assert int(eng2.state.step) == 3
    np.testing.assert_array_equal(
        np.asarray(eng2.state.density), np.asarray(eng.state.density)
    )
    assert eng2.cfg == eng.cfg
    # resumed run continues identically
    eng.step(2)
    eng2.step(2)
    np.testing.assert_allclose(
        np.asarray(eng2.state.density), np.asarray(eng.state.density),
        rtol=1e-6, atol=1e-6,
    )


def test_config_json_roundtrip(tmp_path):
    cfg = tiny_cfg(obstacle_shape=ObstacleShape.AIRFOIL)
    p = str(tmp_path / "cfg.json")
    save_config(p, cfg)
    assert load_config(p) == cfg


def test_config_json_drops_removed_fields(tmp_path):
    """Configs saved before the kernel-selection fields were removed
    still load: the stale keys are dropped by name, with a warning."""
    import json

    from fluidsim_tpu.io.checkpoint import REMOVED_FIELDS, config_to_json

    cfg = tiny_cfg()
    old = json.loads(config_to_json(cfg))
    old.update(solve_dtype="bfloat16", jacobi_sweep_block=2,
               kernel_backend="xla", fuse_project_advect=True,
               fuse_self_advect=False, fuse_buoyancy=True,
               fuse_emitter=False)
    assert set(REMOVED_FIELDS) <= set(old)
    p = tmp_path / "old.json"
    p.write_text(json.dumps(old))
    with pytest.warns(UserWarning, match="removed config fields"):
        assert load_config(str(p)) == cfg


def test_nan_guard():
    eng = Engine(tiny_cfg(enable_custom_source=False), nan_guard=True)
    eng.state = eng.state.replace(
        density=eng.state.density.at[5, 5].set(jnp.nan)
    )
    with pytest.raises(FloatingPointError):
        eng.step(1)


def test_multi_emitter():
    """extra_sources adds independent emitters (BASELINE config 4)."""
    import fluidsim_tpu as fs
    from fluidsim_tpu.config import SourceSpec

    cfg = fs.get_preset("smoke32").replace(
        source_position=(0.25, 0.2, 0.25),
        source_radius=2.0,
        extra_sources=(
            SourceSpec(position=(0.75, 0.2, 0.75), strength=200.0,
                       radius=2.0),
        ),
    )
    eng = Engine(cfg)
    eng.step(2)
    dens = np.asarray(eng.state.density)
    n = cfg.current_size
    # mass deposited around both emitters
    q1 = dens[:, : n // 2, : n // 2].sum()   # [z, y, x]: first emitter x<16,z<16
    left = dens[: n // 2, :, : n // 2].sum()
    right = dens[n // 2 :, :, n // 2 :].sum()
    assert left > 0 and right > 0
    assert right > left  # stronger second emitter


def test_multi_emitter_config_roundtrip(tmp_path):
    import fluidsim_tpu as fs
    from fluidsim_tpu.config import SourceSpec
    from fluidsim_tpu.io.checkpoint import load_config, save_config

    cfg = fs.get_preset("multi256").replace(size=32)
    assert len(cfg.extra_sources) == 2
    p = str(tmp_path / "c.json")
    save_config(p, cfg)
    assert load_config(p) == cfg


def test_orbax_checkpoint_roundtrip(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    from fluidsim_tpu.io.checkpoint import (
        load_checkpoint_orbax,
        save_checkpoint_orbax,
    )

    eng = Engine(tiny_cfg())
    eng.step(3)
    path = str(tmp_path / "ockpt")
    save_checkpoint_orbax(path, eng.state, eng.cfg)
    state, cfg = load_checkpoint_orbax(path)
    assert cfg == eng.cfg
    assert int(state.step) == 3
    np.testing.assert_array_equal(
        np.asarray(state.density), np.asarray(eng.state.density)
    )


def test_fps_ticks_once_per_metrics_sync(tmp_path):
    """The logged FPS is measured between metric syncs: one EMA tick per
    log event covering every step dispatched since the previous tick —
    per-dispatch ticks would time host enqueue intervals (dispatches
    pipeline; the engine no longer syncs each one)."""
    db = str(tmp_path / "m.db")
    with MetricsStore(db) as store:
        cfg = tiny_cfg(enable_runtime_logging=True, logging_interval=10)
        eng = Engine(cfg, store=store)
        ticks = []
        real_tick = eng._fps.tick

        def spy_tick(now=None, frames=1):
            ticks.append(frames)
            return real_tick(now=now, frames=frames)

        eng._fps.tick = spy_tick
        # 3 pipelined dispatches of 5 steps between each log event
        for _ in range(6):
            eng.step(5, substeps_per_dispatch=5)
    assert ticks == [10, 10, 10]
    assert eng._fps_pending == 0
