"""Simulation driver — the host-side equivalent of the reference's
``Update()`` loop (FluidSim.cs:390-450) and MonoBehaviour lifecycle.

The engine owns:

* one **fused jitted step**: emitter injection + solver step compiled into a
  single XLA program (the reference re-enters managed code between every
  kernel; here nothing leaves the device between sub-steps).  Multi-step
  rollouts run under ``lax.scan`` so even the per-call dispatch cost
  amortizes away.
* the interaction API (mouse-drag forces, source repositioning —
  FluidSim.cs:397-436, 979-988) as explicit methods,
* pause (FluidSim.cs:149-153), reset (``ResetSimulation``,
  FluidSim.cs:213-300),
* metrics logging every ``logging_interval`` steps to the SQLite store
  (FluidSim.cs:572-575) with the reference's smoothed-FPS EMA,
* an optional NaN guard (the failure-detection analog SURVEY.md §5.3
  suggests): detects a diverged field and raises with the offending step.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import SimConfig
from .metrics import FrameRateTracker, MetricsStore, compute_metrics
from .models.stable2d import simulate_step_2d
from .models.stable3d import simulate_step_3d
from .scene.interact import add_force_to_area, mouse_drag_force
from .scene.obstacles import build_obstacle_mask
from .scene.sources import SourceParams, apply_custom_source, source_params
from .state import FluidState, zeros_state


class Engine:
    """Host driver for a fluid simulation."""

    def __init__(self, cfg: SimConfig, store: Optional[MetricsStore] = None,
                 nan_guard: bool = False,
                 crash_snapshot_path: Optional[str] = None):
        """``crash_snapshot_path``: with ``nan_guard``, dump the last good
        state there before raising (the elastic-recovery hook SURVEY.md
        §5.3 suggests — resume with ``Engine.from_checkpoint``)."""
        self.cfg = cfg.validate()
        self.paused = False
        self.nan_guard = nan_guard
        self.crash_snapshot_path = crash_snapshot_path
        self._last_good: Optional[FluidState] = None
        self.store = store
        self.run_id = store.save_run_params(cfg) if store else -1
        self._fps = FrameRateTracker()
        self._fps_pending = 0  # steps dispatched since the last FPS tick
        self._step_cache = {}
        self._clock = time.perf_counter  # swappable for tests
        self.reset()

    # -- lifecycle ------------------------------------------------------

    def reset(self) -> None:
        """``ResetSimulation`` (FluidSim.cs:213-300): reallocate fields and
        re-rasterize obstacles from the current config."""
        obst = build_obstacle_mask(self.cfg)
        self.state = zeros_state(self.cfg, obstacles=jnp.asarray(obst))
        self._src_params = source_params(self.cfg)
        self._host_step = 0
        self._fps_pending = 0
        # Wall-clock elapsedTime for pulse_clock="wall" (FluidSim.cs:394):
        # accumulates frame deltas only while unpaused.
        self._elapsed = 0.0
        self._wall_prev: Optional[float] = None

    def set_config(self, cfg: SimConfig) -> None:
        """``OnValidate`` analog (FluidSim.cs:154-180): grid-shape changes
        reset state; parameter-only changes re-rasterize obstacles and
        recompile lazily."""
        old_shape = self.cfg.grid_shape
        self.cfg = cfg.validate()
        self._step_cache.clear()
        if cfg.grid_shape != old_shape:
            self.reset()
        else:
            self.state = self.state.replace(
                obstacles=jnp.asarray(build_obstacle_mask(cfg))
            )
            self._src_params = source_params(self.cfg)

    def set_paused(self, paused: bool) -> None:
        """FluidSim.cs:149-153."""
        if self.paused and not paused:
            # Resume: drop the pause gap from the wall-clock accumulator
            # (Unity's next deltaTime is one frame, not the pause length).
            self._wall_prev = None
        self.paused = paused

    # -- stepping -------------------------------------------------------

    def _solver_step(self, state: FluidState) -> FluidState:
        if self.cfg.ndim == 3:
            return simulate_step_3d(state, self.cfg)
        return simulate_step_2d(state, self.cfg)

    def _fused_step(self, n_substeps: int):
        """Compile (and cache) emitter + solver for ``n_substeps``."""
        key = n_substeps
        if key in self._step_cache:
            return self._step_cache[key]
        cfg = self.cfg
        dt = jnp.float32(cfg.effective_params()[0])

        def one(src: SourceParams, state, _):
            t = state.time + dt
            density, velocity = apply_custom_source(
                state.density, state.velocity, cfg, t, params=src
            )
            state = state.replace(density=density, velocity=velocity)
            return self._solver_step(state), None

        @jax.jit
        def stepper(state, src: SourceParams):
            # Emitter values are traced operands: repositioning the source
            # (shift-drag, FluidSim.cs:397-402) never triggers a retrace.
            if n_substeps == 1:
                return one(src, state, None)[0]
            return jax.lax.scan(
                lambda s, x: one(src, s, x), state, None, length=n_substeps
            )[0]

        self._step_cache[key] = stepper
        return stepper

    def step(self, n: int = 1, substeps_per_dispatch: int = 1) -> FluidState:
        """Advance ``n`` steps (no-op while paused, FluidSim.cs:392).

        ``substeps_per_dispatch > 1`` rolls that many steps into one
        ``lax.scan`` dispatch — use for throughput runs; metrics are then
        sampled once per dispatch.
        """
        now = self._clock()
        delta = (now - self._wall_prev) if self._wall_prev is not None else 0.0
        # Unity clamps per-frame deltaTime to Maximum Allowed Timestep
        # (ProjectSettings/TimeManager.asset: 0.33333334), so a host hitch
        # never jumps elapsedTime — match that for the wall pulse clock.
        delta = min(delta, 0.33333334)
        self._wall_prev = now
        if self.paused:
            # elapsedTime does not advance across paused frames
            # (Update() returns before the += at FluidSim.cs:392-394).
            return self.state
        if self.cfg.pulse_clock == "wall":
            self._elapsed += delta
            self._src_params = self._src_params._replace(
                pulse_t=jnp.float32(self._elapsed)
            )
        stepper = self._fused_step(substeps_per_dispatch)
        dispatches, rem = divmod(n, substeps_per_dispatch)
        for _ in range(dispatches):
            self.state = stepper(self.state, self._src_params)
            self._after_dispatch(substeps_per_dispatch)
        if rem:
            stepper1 = self._fused_step(1)
            for _ in range(rem):
                self.state = stepper1(self.state, self._src_params)
                self._after_dispatch(1)
        return self.state

    def _after_dispatch(self, n_steps: int) -> None:
        self._fps_pending += n_steps
        # Host-side step counter: fetching ``int(self.state.step)`` here
        # would force a device sync after every dispatch.  The count is
        # fully determined host-side, so dispatches pipeline back-to-back
        # and only the nan guard / metrics interval touch the device.
        self._host_step += n_steps
        step_now = self._host_step
        if self.nan_guard:
            if bool(jnp.isnan(self.state.density).any()):
                if self.crash_snapshot_path and self._last_good is not None:
                    from .io.checkpoint import save_checkpoint

                    save_checkpoint(
                        self.crash_snapshot_path, self._last_good, self.cfg
                    )
                raise FloatingPointError(
                    f"NaN detected in density at step {step_now}"
                    + (
                        f"; last good state saved to {self.crash_snapshot_path}"
                        if self.crash_snapshot_path and self._last_good is not None
                        else ""
                    )
                )
            if self.crash_snapshot_path is not None:
                self._last_good = self.state
        if (
            self.store is not None
            and self.cfg.enable_runtime_logging
            and step_now % max(self.cfg.logging_interval, 1) < n_steps
        ):
            avg, vmax = compute_metrics(self.state.density, self.state.velocity)
            avg_f, vmax_f = float(avg), float(vmax)  # device sync
            # FPS is measured between metric syncs (the only points where
            # wall time reflects completed device work — dispatches
            # pipeline), covering every step since the previous tick.
            fps = self._fps.tick(frames=self._fps_pending)
            self._fps_pending = 0
            self.store.log_runtime_metrics(
                self.run_id, step_now, avg_f, vmax_f, fps
            )

    # -- interaction (FluidSim.cs:390-483, 979-988) ---------------------

    def get_source_position(self) -> Tuple[float, ...]:
        """Grid-coordinate source position (FluidSim.cs:979-982)."""
        n = self.cfg.current_size
        return tuple(p * n for p in self.cfg.source_position)

    def set_source_position(self, *coords: float) -> None:
        """Clamped normalized reposition (FluidSim.cs:984-988).

        The position is a traced operand of the jitted step, so this is a
        per-frame-cheap operation (no retrace), matching the reference's
        per-frame shift-drag semantics.
        """
        n = self.cfg.current_size
        pos = tuple(float(np.clip(c / n, 0.0, 1.0)) for c in coords)
        self.cfg = self.cfg.replace(source_position=pos)
        self._src_params = self._src_params._replace(
            position=jnp.asarray(pos[: self.cfg.ndim], jnp.float32)
        )

    def drag(self, prev_pos: Sequence[float], cur_pos: Sequence[float]) -> None:
        """Apply one mouse-drag event (FluidSim.cs:414-436)."""
        center, force, radius = mouse_drag_force(
            tuple(prev_pos), tuple(cur_pos), self.cfg
        )
        vel, density = add_force_to_area(
            self.state.velocity, self.state.density, center, force, radius,
            self.cfg.source_strength,
        )
        self.state = self.state.replace(velocity=vel, density=density)

    # -- persistence ----------------------------------------------------

    def save_configuration(self) -> int:
        """``SaveCurrentConfiguration`` (FluidSim.cs:2004-2023)."""
        if self.store is None:
            return -1
        return self.store.save_run_params(self.cfg)

    def save_checkpoint(self, path: str) -> None:
        from .io.checkpoint import save_checkpoint

        save_checkpoint(path, self.state, self.cfg)

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "Engine":
        from .io.checkpoint import load_checkpoint

        state, cfg = load_checkpoint(path)
        eng = cls(cfg, **kw)
        eng.state = state
        eng._host_step = int(state.step)
        return eng
