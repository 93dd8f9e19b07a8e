"""Checkpoint / resume.

The reference persists *config only* (the 15 scene parameters,
SQL.cs:46-96) and rebuilds state from scratch via ``ResetSimulation``
(FluidSim.cs:213-300) — field state is lost on exit.  This module keeps
that config persistence (JSON here; the SQLite row in ``metrics.py`` is the
schema-parity path) and adds full field-state snapshots, the cheap win
SURVEY.md §5.4 calls out.

Snapshots are ``.npz`` (portable, dependency-free).  For sharded state the
arrays are gathered to host — fine at the sizes involved; an orbax-based
async path can layer on top without changing the format contract.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..config import ColorMode, ObstacleShape, SimConfig
from ..state import FluidState


def save_checkpoint(path: str, state: FluidState, cfg: SimConfig) -> None:
    """Write state + config to ``path`` (.npz)."""
    np.savez_compressed(
        path,
        density=np.asarray(state.density),
        velocity=np.asarray(state.velocity),
        pressure=np.asarray(state.pressure),
        obstacles=np.asarray(state.obstacles),
        step=np.asarray(state.step),
        time=np.asarray(state.time),
        config_json=np.bytes_(config_to_json(cfg).encode()),
    )


def load_checkpoint(path: str) -> Tuple[FluidState, SimConfig]:
    """Read state + config back; arrays land on the default device."""
    with np.load(path, allow_pickle=False) as z:
        cfg = config_from_json(bytes(z["config_json"]).decode())
        state = FluidState(
            density=jnp.asarray(z["density"]),
            velocity=jnp.asarray(z["velocity"]),
            pressure=jnp.asarray(z["pressure"]),
            obstacles=jnp.asarray(z["obstacles"]),
            step=jnp.asarray(z["step"]),
            time=jnp.asarray(z["time"]),
        )
    return state, cfg


# -- config (de)serialization ------------------------------------------

def config_to_json(cfg: SimConfig) -> str:
    d = dataclasses.asdict(cfg)
    d["obstacle_shape"] = int(cfg.obstacle_shape)
    d["color_mode"] = int(cfg.color_mode)
    return json.dumps(d, indent=2)


# Fields of configs saved by earlier versions that no longer exist: they
# only selected hand-written kernels that were removed, so dropping them
# changes no result.
REMOVED_FIELDS = (
    "solve_dtype", "jacobi_sweep_block", "kernel_backend",
    "fuse_project_advect", "fuse_self_advect", "fuse_buoyancy",
    "fuse_emitter",
)


def config_from_json(s: str) -> SimConfig:
    from ..config import SourceSpec

    d = json.loads(s)
    dropped = [k for k in REMOVED_FIELDS if k in d]
    if dropped:
        warnings.warn(
            f"ignoring removed config fields {dropped} (they selected "
            "kernels that no longer exist; results are unchanged)",
            stacklevel=2,
        )
        for k in dropped:
            del d[k]
    d["obstacle_shape"] = ObstacleShape(d["obstacle_shape"])
    d["color_mode"] = ColorMode(d["color_mode"])
    for key in ("source_position", "obstacle_position", "source_velocity_dir",
                "gradient_times"):
        if key in d:
            d[key] = tuple(d[key])
    if "extra_sources" in d:
        d["extra_sources"] = tuple(
            SourceSpec(
                **{
                    k: tuple(v) if isinstance(v, list) else v
                    for k, v in spec.items()
                }
            )
            for spec in d["extra_sources"]
        )
    for key in list(d):
        if key.endswith("_color") or key in ("fluid_color", "gradient_colors"):
            v = d[key]
            if isinstance(v, list):
                d[key] = tuple(
                    tuple(c) if isinstance(c, list) else c for c in v
                )
    return SimConfig(**d)


def save_config(path: str, cfg: SimConfig) -> None:
    with open(path, "w") as f:
        f.write(config_to_json(cfg))


def load_config(path: str) -> SimConfig:
    with open(path) as f:
        return config_from_json(f.read())


# -- orbax (optional, for sharded/async checkpoints) --------------------

def save_checkpoint_orbax(path: str, state: FluidState, cfg: SimConfig) -> None:
    """Orbax-backed snapshot — preserves device sharding layout and scales
    to multi-host; the .npz path gathers everything to one host first.
    Requires the optional orbax-checkpoint package; config is stored as
    JSON alongside.
    """
    import os

    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, dict(
        density=state.density,
        velocity=state.velocity,
        pressure=state.pressure,
        obstacles=state.obstacles,
        step=state.step,
        time=state.time,
    ), force=True)
    ckptr.wait_until_finished()
    with open(path + ".config.json", "w") as f:
        f.write(config_to_json(cfg))


def load_checkpoint_orbax(path: str):
    """Restore an orbax snapshot; returns (FluidState, SimConfig)."""
    import os

    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    with open(path + ".config.json") as f:
        cfg = config_from_json(f.read())
    ckptr = ocp.StandardCheckpointer()
    restored = ckptr.restore(path)
    state = FluidState(
        density=restored["density"],
        velocity=restored["velocity"],
        pressure=restored["pressure"],
        obstacles=restored["obstacles"],
        step=restored["step"],
        time=restored["time"],
    )
    return state, cfg
