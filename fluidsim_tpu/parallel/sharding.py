"""Spatial domain decomposition over a device mesh.

The reference is single-process/single-node; its only "communication" is
managed↔native buffer copies (SURVEY.md §2, L1).  The scaling axis here
(BASELINE config 5: the 512³ grid over several devices) is a **slab
decomposition**: the voxel grid is sharded along z (axis 0 of ``[z, y, x]``
fields) across a 1-D ``jax.sharding.Mesh``, and every stencil's neighbor
access compiles to a halo exchange between neighboring devices.

Two paths:

* this module — ``pjit``-style: jit the *unchanged* solver with sharded
  inputs/outputs and let XLA insert the collectives for the shifted slices.
  Zero solver changes; the compiler pipelines the edge-plane exchanges.
* ``halo.py`` — explicit ``shard_map`` + ``ppermute`` edge-slab exchange.

z is the **leading** axis, so each shard's slab is one contiguous block of
memory and the exchanged edge planes are contiguous too.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SimConfig
from ..state import FluidState


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = "z") -> Mesh:
    """1-D device mesh for slab decomposition."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def state_sharding(mesh: Mesh, axis_name: str = "z"):
    """Shardings for each FluidState leaf: fields split along the z axis
    (axis 0 of a [z, y, x] field; axis 1 of the (3, z, y, x) velocity)."""
    field = NamedSharding(mesh, P(axis_name, None, None))
    vel = NamedSharding(mesh, P(None, axis_name, None, None))
    scalar = NamedSharding(mesh, P())
    return FluidState(
        density=field,
        velocity=vel,
        pressure=field,
        obstacles=field,
        step=scalar,
        time=scalar,
    )


def shard_state(state: FluidState, mesh: Mesh, axis_name: str = "z") -> FluidState:
    """Place an (unsharded) state onto the mesh with slab sharding."""
    sh = state_sharding(mesh, axis_name)
    return jax.tree_util.tree_map(jax.device_put, state, sh)


def sharded_step_fn(cfg: SimConfig, mesh: Mesh, axis_name: str = "z",
                    n_substeps: int = 1, with_source: bool = True,
                    halo: str = "auto", halo_block_iters: int = 1):
    """Compile the full 3D step for a slab-sharded state.

    ``halo`` selects the stencil-communication strategy for the pressure
    solve (the step's dominant communicator — one halo exchange per Jacobi
    sweep):

    * ``"auto"`` — the solver body is *identical* to the single-device one;
      XLA's auto-partitioner lowers the stencil shifts on sharded arrays to
      collective-permutes of the single-plane halos.
    * ``"explicit"`` — the pressure solve routes through
      ``parallel.halo.jacobi_3d_sharded``: hand-written ``shard_map`` +
      per-sweep ``ppermute`` edge-plane exchange.  Same numerics (tested).
      Obstacle scenes are supported: the solve carries the mask as a
      coefficient volume (copy-through; the mask's own halo is exchanged
      once per solve), while advection stays on the auto-partitioned
      XLA path.  ``halo_block_iters=T>1`` switches the exchange cadence
      to the communication-avoiding schedule (T-deep halos every T
      sweeps — identical results, T× fewer round-trips; see
      ``parallel.halo``).

    ``n_substeps > 1`` rolls steps into one program via ``lax.scan`` so
    halo exchanges pipeline with compute.
    """
    from ..models.stable3d import simulate_step_3d
    from ..scene.sources import apply_custom_source

    if cfg.ndim != 3:
        raise ValueError("sharded_step_fn is for the 3D engine")
    if halo not in ("auto", "explicit"):
        raise ValueError(f"halo must be 'auto' or 'explicit', got {halo!r}")
    if halo == "auto" and halo_block_iters != 1:
        raise ValueError(
            "halo_block_iters only applies to halo='explicit' (the auto "
            "path's exchange cadence is chosen by XLA); pass "
            "halo='explicit' to use the communication-avoiding schedule"
        )
    jacobi_fn = None
    if halo == "explicit":
        if cfg.pressure_solver == "fft":
            raise ValueError(
                "halo='explicit' replaces the Jacobi pressure solve and "
                "cannot be combined with pressure_solver='fft'"
            )
        from .halo import jacobi_3d_sharded

        def jacobi_fn(p, div, iters, obst=None):
            return jacobi_3d_sharded(p, div, 1.0, 6.0, iters, mesh,
                                     axis_name, b=0,
                                     block_iters=halo_block_iters,
                                     obst=obst)

    sh = state_sharding(mesh, axis_name)
    dt = np.float32(cfg.effective_params()[0])

    def one(state, _):
        if with_source and cfg.enable_custom_source:
            t = state.time + dt
            density, velocity = apply_custom_source(
                state.density, state.velocity, cfg, t
            )
            state = state.replace(density=density, velocity=velocity)
        return simulate_step_3d(state, cfg, jacobi_fn=jacobi_fn), None

    def body(state):
        if n_substeps == 1:
            return one(state, None)[0]
        return jax.lax.scan(one, state, None, length=n_substeps)[0]

    return jax.jit(body, in_shardings=(sh,), out_shardings=sh)
