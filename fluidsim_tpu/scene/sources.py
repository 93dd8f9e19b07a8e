"""Continuous emitters and point injectors.

Reference: ``UpdateCustomSource`` (FluidSim.cs:485-533) and
``AddDensity``/``AddVelocity`` (FluidSim.cs:723-738).

The reference loops over the emitter's bounding box and calls the point
injectors per cell; every cell it touches satisfies ``dist ≤ radius``, so a
full-grid masked add is float32-identical and fuses into the jitted step.

Beyond the reference's single emitter, ``cfg.extra_sources`` adds any
number of additional ``SourceSpec`` emitters (BASELINE config 4).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SimConfig, SourceSpec


def _cell_centers(shape, dtype):
    """Per-axis coordinate grids in (x, y[, z]) order for [y,x]/[z,y,x] arrays."""
    ranges = [jnp.arange(s, dtype=dtype) for s in shape]
    grids = jnp.meshgrid(*ranges, indexing="ij")  # [y,x] or [z,y,x] order
    return tuple(reversed(grids))  # (x, y[, z])


def pulse_scale(t, rate: float):
    """|sin(t · rate · π)| (FluidSim.cs:492-494)."""
    return jnp.abs(jnp.sin(t * np.float32(rate) * np.float32(np.pi)))


class SourceParams(NamedTuple):
    """Scene-dynamic emitter values as *traced operands* of the jitted step.

    The reference repositions the emitter per frame with shift-drag
    (FluidSim.cs:397-402) — a per-frame operation, so these must not be
    baked into the compiled program as constants (a reposition would
    otherwise retrace/recompile the whole step, seconds per mouse event).  Structural switches (pulsing, emits_velocity, enabled) stay
    static in ``SimConfig``.
    """

    position: jnp.ndarray   # (ndim,) normalized [0, 1], (x, y[, z]) order
    strength: jnp.ndarray   # () base strength (pre resolution scaling)
    radius: jnp.ndarray     # () base radius in cells (pre res scaling)
    velocity: jnp.ndarray   # () emitted |v| (pre res scaling)
    dir_vec: jnp.ndarray    # (ndim,) unit emission direction
    pulse_t: jnp.ndarray    # () wall-clock elapsedTime (pulse_clock="wall")


def source_params(cfg: SimConfig) -> SourceParams:
    """Build the traced emitter operands from the current config."""
    if cfg.ndim == 2:
        ang = np.float32(np.deg2rad(np.float32(cfg.source_direction)))
        dir_vec = np.array(
            [np.cos(ang), np.sin(ang)], dtype=np.float32
        )
    else:
        d = np.asarray(cfg.source_velocity_dir, dtype=np.float32)
        dir_vec = (d / max(np.linalg.norm(d), 1e-8)).astype(np.float32)
    return SourceParams(
        position=jnp.asarray(cfg.source_position[: cfg.ndim], jnp.float32),
        strength=jnp.float32(cfg.source_strength),
        radius=jnp.float32(cfg.source_radius),
        velocity=jnp.float32(cfg.source_velocity),
        dir_vec=jnp.asarray(dir_vec),
        pulse_t=jnp.float32(0.0),
    )


def _spec_params(spec: SourceSpec, ndim: int) -> SourceParams:
    """Static ``SourceParams`` for an ``extra_sources`` entry."""
    if ndim == 2:
        ang = np.float32(np.deg2rad(np.float32(spec.direction)))
        dir_vec = np.array([np.cos(ang), np.sin(ang)], dtype=np.float32)
    else:
        d = np.asarray(spec.velocity_dir, dtype=np.float32)
        dir_vec = (d / max(np.linalg.norm(d), 1e-8)).astype(np.float32)
    return SourceParams(
        position=jnp.asarray(spec.position[:ndim], jnp.float32),
        strength=jnp.float32(spec.strength),
        radius=jnp.float32(spec.radius),
        velocity=jnp.float32(spec.velocity),
        dir_vec=jnp.asarray(dir_vec),
        pulse_t=jnp.float32(0.0),
    )


def _apply_one(density, vel, cfg: SimConfig, t, params: SourceParams, *,
               emits_velocity: bool, pulsing: bool, pulse_rate: float):
    """One emitter: pulsing, radial linear falloff, optional directional
    velocity (FluidSim.cs:485-533), resolution-scaled.

    ``params`` values may be traced (the live path) or constants (presets);
    the float32 op order is identical either way.
    """
    n = cfg.current_size
    dtype = density.dtype
    nf = np.float32(n)
    res_mult = np.float32(cfg.resolution_multiplier)

    radius_cells = jnp.asarray(params.radius, jnp.float32) * res_mult

    scale = pulse_scale(t, pulse_rate) if pulsing else np.float32(1.0)
    eff_strength = jnp.asarray(params.strength, jnp.float32) * scale * res_mult

    pos = jnp.asarray(params.position, jnp.float32)
    # Coordinates/falloff in f32 even for narrow field storage (bf16 can't
    # represent cell indices > 256); only the final add is in field dtype.
    coords = _cell_centers(density.shape, jnp.float32)
    dist = jnp.sqrt(
        sum((c - pos[i] * nf) ** 2 for i, c in enumerate(coords))
    )
    mask = dist <= radius_cells
    falloff = jnp.where(mask, 1.0 - dist / radius_cells, 0.0)

    density = density + (eff_strength * falloff).astype(dtype)

    if emits_velocity:
        vmag = jnp.asarray(params.velocity, jnp.float32) * res_mult
        dir_vec = jnp.asarray(params.dir_vec, jnp.float32)
        for c in range(cfg.ndim):
            vel = vel.at[c].add(
                (dir_vec[c] * vmag * falloff).astype(vel.dtype)
            )

    return density, vel


def apply_custom_source(density, vel, cfg: SimConfig, t,
                        params: SourceParams = None):
    """One frame of all continuous emitters; no-op config ⇒ identity.

    ``t`` is the elapsed time used for pulsing.  With
    ``cfg.pulse_clock == "sim"`` (default) that is accumulated sim time;
    with ``"wall"`` and traced ``params``, the engine-maintained
    wall-clock ``params.pulse_t`` is used instead — the reference's exact
    semantics (``elapsedTime`` accumulates ``Time.deltaTime`` while
    unpaused, FluidSim.cs:394, and drives the pulse at :492-494).
    ``params`` overrides the main emitter's scene-dynamic values with
    traced operands (see ``SourceParams``); ``None`` uses the config's
    values as constants.  Returns (density, vel).
    """
    if cfg.pulse_clock == "wall" and params is not None:
        t = params.pulse_t
    if cfg.enable_custom_source:
        density, vel = _apply_one(
            density, vel, cfg, t,
            params if params is not None else source_params(cfg),
            emits_velocity=cfg.source_emits_velocity,
            pulsing=cfg.source_pulsing,
            pulse_rate=cfg.source_pulse_rate,
        )
    for spec in cfg.extra_sources:
        density, vel = _apply_one(
            density, vel, cfg, t, _spec_params(spec, cfg.ndim),
            emits_velocity=spec.emits_velocity,
            pulsing=spec.pulsing,
            pulse_rate=spec.pulse_rate,
        )
    return density, vel


def add_density(density, x: float, y: float, amount, z: float = None):
    """Point injector (FluidSim.cs:723-729): truncate + clamp coordinates."""
    n = density.shape[-1]
    idx = _clamp_idx((x, y) if z is None else (x, y, z), n)
    return density.at[idx].add(amount)


def add_velocity(vel, x: float, y: float, amounts, z: float = None):
    """Point injector (FluidSim.cs:731-738)."""
    n = vel.shape[-1]
    idx = _clamp_idx((x, y) if z is None else (x, y, z), n)
    for c, amt in enumerate(amounts):
        vel = vel.at[(c,) + idx].add(amt)
    return vel


def _clamp_idx(coords_xy, n):
    """(x, y[, z]) floats → clamped int array index ([y, x] / [z, y, x])."""
    ints = [int(np.clip(int(c), 0, n - 1)) for c in coords_xy]
    return tuple(reversed(ints))
