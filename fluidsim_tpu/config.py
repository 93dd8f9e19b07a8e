"""Simulation configuration.

Mirrors the reference's Unity-Inspector parameter surface
(the reference's Assets/Scripts/FluidSim.cs:12-110) as a frozen, hashable
dataclass so a ``SimConfig`` can be passed to ``jax.jit`` as a static
argument.  Ranges from the reference's ``[Range]`` attributes are enforced in
``validate()``; the auto-adjust rule (FluidSim.cs:216-222, 554-556) lives in
``effective_params``.

Scene presets A/B replicate the two serialized instances in
Assets/Scenes/SampleScene.unity:242-343 and :518-612.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

import numpy as np


class ColorMode(enum.IntEnum):
    """FluidSim.cs:32 — enum ColorMode."""

    SINGLE_COLOR = 0
    GRADIENT = 1
    DENSITY_BASED = 2
    PRESSURE_BASED = 3
    STREAMLINES = 4


class ObstacleShape(enum.IntEnum):
    """FluidSim.cs:98 — enum ObstacleShape."""

    CIRCLE = 0
    RECTANGLE = 1
    AIRFOIL = 2


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    """One additional continuous emitter (BASELINE config 4 is a
    multi-emitter scene; the reference supports a single emitter —
    FluidSim.cs:34-55 — which remains the primary ``source_*`` fields)."""

    position: Tuple[float, ...] = (0.5, 0.5, 0.5)  # normalized
    strength: float = 100.0
    radius: float = 1.0
    emits_velocity: bool = False
    velocity: float = 10.0
    direction: float = 0.0                  # degrees, 2D mode
    velocity_dir: Tuple[float, float, float] = (0.0, 1.0, 0.0)  # 3D mode
    pulsing: bool = False
    pulse_rate: float = 1.0


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Full parameter surface of the reference simulation.

    All defaults equal the reference's C# field initializers
    (FluidSim.cs:12-110), which are also scene preset B.
    """

    # -- core solver (FluidSim.cs:19-31) --------------------------------
    size: int = 128                     # [Range(32, 512)] per-axis grid size
    physical_size: float = 1.0          # physical extent of the domain
    resolution_multiplier: float = 1.0  # [Range(0.1, 10)]
    diffusion: float = 1e-4
    viscosity: float = 1e-4
    time_step: float = 0.1
    auto_adjust_parameters: bool = True
    apply_turbulent_noise: bool = False

    # -- dimensionality (new axis; the reference is 2D-only) ------------
    ndim: int = 2                       # 2 = reference-parity mode, 3 = voxel engine
    # number of Jacobi iterations; the reference hard-codes 20
    # (FluidSim.cs:1310,1378,1594).
    jacobi_iters: int = 20
    # The reference's Diffuse() runs the 20-iter self-smoothing solve AND a
    # 20-iter fixed-rhs solve back to back (FluidSim.cs:740-745).  True
    # reproduces that 40-sweep quirk; False runs a single fixed-rhs solve.
    double_diffuse: bool = True
    # The reference projects twice per velocity step (FluidSim.cs:708,713).
    # The 3D solver defaults to the standard single post-advection
    # projection; set True for the reference-style double projection.
    double_project: bool = False
    # 3D advection formulation: 0 = exact 8-tap trilinear gather,
    # K>0 = windowed hat-weight sum over static shifts — identical to
    # the gather while |displacement| < K cells, with displacement clamped
    # to K (a CFL limiter).  See ops/advect.py.
    advect_window: int = 0

    # -- 3D-only physics (BASELINE configs 2-3; absent from reference) --
    buoyancy: float = 0.0               # upward force ∝ density
    ambient_density: float = 0.0        # buoyancy reference density
    vorticity_confinement: float = 0.0  # ε for vorticity confinement force
    gravity: float = 0.0                # downward force on dense fluid
    # Exponential sinks (Stam's "dissipation" term, standard in smoke
    # solvers; absent from the reference, 3D engine only).  Per step:
    # density *= 1/(1 + dt·density_dissipation) and (after projection,
    # which a scalar multiple preserves) velocity *= 1/(1 + dt·
    # velocity_damping).  With a continuous emitter these give the scene
    # a genuine bounded steady state — without a sink total mass, hence
    # buoyancy, hence |v| grow without bound and the CFL limiter ends up
    # dominating transport (see tools/cfl_probe.py).
    density_dissipation: float = 0.0    # 1/time units
    velocity_damping: float = 0.0       # 1/time units

    # -- custom source (FluidSim.cs:34-55) ------------------------------
    enable_custom_source: bool = False
    source_strength: float = 100.0      # [Range(1, 500)]
    source_emits_velocity: bool = False
    source_direction: float = 0.0       # degrees [Range(0, 360)]
    source_velocity: float = 10.0       # [Range(1, 50)]
    source_radius: float = 1.0          # [Range(0.1, 10)]
    source_pulse_rate: float = 1.0      # [Range(0.1, 5)]
    source_pulsing: bool = False
    source_position: Tuple[float, ...] = (0.5, 0.5)  # normalized (x, y[, z])
    # Clock driving the pulse phase: "sim" uses accumulated simulation time
    # (deterministic — the default for reproducible runs/benchmarks);
    # "wall" matches the reference exactly: ``elapsedTime`` accumulates
    # wall-clock frame deltas while unpaused (FluidSim.cs:394,492-494) and
    # is fed to the jitted step as a traced operand (no retrace per frame).
    pulse_clock: str = "sim"
    # 3D-only: unit direction of emitted velocity (the 2D mode uses the
    # reference's source_direction angle, FluidSim.cs:524).
    source_velocity_dir: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    # Additional emitters beyond the reference's single source.
    extra_sources: Tuple["SourceSpec", ...] = ()

    # -- obstacle (FluidSim.cs:96-110) ----------------------------------
    enable_obstacle: bool = True
    obstacle_shape: ObstacleShape = ObstacleShape.CIRCLE
    obstacle_position: Tuple[float, ...] = (0.5, 0.5)  # normalized
    obstacle_radius: float = 0.1        # [Range(0.01, 0.5)]
    obstacle_width: float = 0.2         # [Range(0.01, 0.5)]
    obstacle_height: float = 0.2        # [Range(0.01, 0.5)]

    # -- visualization (FluidSim.cs:57-94) ------------------------------
    color_mode: ColorMode = ColorMode.SINGLE_COLOR
    fluid_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    colour_intensity: float = 1.0
    use_lerp: bool = False
    start_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    end_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    low_pressure_color: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)
    neutral_pressure_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    high_pressure_color: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 1.0)
    low_pressure_threshold: float = -50.0
    high_pressure_threshold: float = 50.0
    low_density_color: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)
    medium_density_color: Tuple[float, float, float, float] = (0.0, 1.0, 0.0, 1.0)
    high_density_color: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 1.0)
    medium_density_threshold: float = 50.0
    high_density_threshold: float = 200.0
    obstacle_color: Tuple[float, float, float, float] = (0.5, 0.5, 0.5, 1.0)
    source_position_color: Tuple[float, float, float, float] = (1.0, 0.92, 0.016, 1.0)
    visualize_source_position: bool = True
    show_streamlines: bool = False
    streamline_density: int = 4         # [Range(1, 5)]
    streamline_scale: float = 1.0       # [Range(1, 10)]
    streamline_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    streamline_thickness: float = 1.0   # [Range(0.1, 3)]
    gradient_colors: Tuple[Tuple[float, float, float, float], ...] = (
        (0.0, 0.0, 1.0, 1.0),
        (1.0, 0.0, 0.0, 1.0),
    )  # default blue→red gradient fabricated in Start() (FluidSim.cs:188-203)
    gradient_times: Tuple[float, ...] = (0.0, 1.0)

    # -- logging (FluidSim.cs:12-17) ------------------------------------
    enable_runtime_logging: bool = True
    logging_interval: int = 10

    # -- numerics (new; the reference is float32-only) ------------------
    dtype: str = "float32"
    # 3D advection scheme: "semi_lagrangian" (the reference's first-order
    # scheme) or "maccormack" (second-order BFECC-style with a
    # monotonicity limiter — less numerical diffusion, no reference
    # counterpart).
    advection_scheme: str = "semi_lagrangian"
    # Number of sub-advections for advection_scheme="substep".
    advect_substeps: int = 2
    # Pressure solver for the 3D engine: "jacobi" = the reference-family
    # iterative solve (cfg.jacobi_iters sweeps); "fft" = exact spectral
    # projection (ops/fft_poisson.py) — obstacle-free closed-box scenes
    # only, removes divergence to machine precision in one shot.
    pressure_solver: str = "jacobi"

    # ------------------------------------------------------------------

    @property
    def current_size(self) -> int:
        """currentSize = round(size * resolutionMultiplier) (FluidSim.cs:216).

        Uses round-half-up like Unity's Mathf.RoundToInt-on-positive values.
        """
        return int(math.floor(self.size * self.resolution_multiplier + 0.5))

    @property
    def cell_size(self) -> float:
        """cellSize = physicalSize / currentSize (FluidSim.cs:219), in f32."""
        return float(np.float32(self.physical_size) / np.float32(self.current_size))

    @property
    def dt_scale(self) -> float:
        """dtScale = 128 / currentSize when auto-adjusting (FluidSim.cs:222)."""
        if not self.auto_adjust_parameters:
            return 1.0
        return float(np.float32(128.0) / np.float32(self.current_size))

    def effective_params(self) -> Tuple[float, float, float]:
        """(dt, diffusion, viscosity) after auto-adjust (FluidSim.cs:554-556).

        All arithmetic in float32 to match the reference.
        """
        if self.auto_adjust_parameters:
            dt = np.float32(self.time_step) * np.float32(self.dt_scale)
            diff = np.float32(self.diffusion) / np.float32(self.resolution_multiplier)
            visc = np.float32(self.viscosity) / np.float32(self.resolution_multiplier)
        else:
            dt = np.float32(self.time_step)
            diff = np.float32(self.diffusion)
            visc = np.float32(self.viscosity)
        return float(dt), float(diff), float(visc)

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        return (self.current_size,) * self.ndim

    def validate(self) -> "SimConfig":
        """Enforce the reference's [Range] clamps; raise on structural errors."""
        if self.ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {self.ndim}")
        if not (32 <= self.size <= 512):
            raise ValueError(f"size out of [32, 512]: {self.size}")
        if not (0.1 <= self.resolution_multiplier <= 10.0):
            raise ValueError(
                f"resolution_multiplier out of [0.1, 10]: {self.resolution_multiplier}"
            )
        if len(self.source_position) != self.ndim:
            raise ValueError("source_position length must equal ndim")
        if len(self.obstacle_position) != self.ndim:
            raise ValueError("obstacle_position length must equal ndim")
        if self.jacobi_iters < 1:
            raise ValueError("jacobi_iters must be >= 1")
        if self.pulse_clock not in ("sim", "wall"):
            raise ValueError(
                f"pulse_clock must be 'sim' or 'wall', got {self.pulse_clock!r}"
            )
        return self

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------------
# Scene presets — the two serialized FluidSimulation instances.
# ----------------------------------------------------------------------

def preset_scene_a() -> SimConfig:
    """Instance A "Fluid Simulation" (SampleScene.unity:242-343).

    192² effective grid (size 64 × resMult 3), airfoil obstacle, pulsing
    directional emitter at (0.1, 0.5), DensityBased coloring.
    """
    return SimConfig(
        size=64,
        physical_size=2.0,
        resolution_multiplier=3.0,
        diffusion=1e-4,
        viscosity=1e-5,
        time_step=0.0025,
        enable_custom_source=True,
        source_strength=122.0,
        source_emits_velocity=True,
        source_direction=0.0,
        source_velocity=36.4,
        source_radius=6.2,
        source_pulse_rate=5.0,
        source_position=(0.1, 0.5),
        enable_obstacle=True,
        obstacle_shape=ObstacleShape.AIRFOIL,
        obstacle_position=(0.5, 0.5),
        obstacle_radius=0.1,
        obstacle_width=0.2,
        obstacle_height=0.05,
        color_mode=ColorMode.DENSITY_BASED,
        logging_interval=30,
    ).validate()


def preset_scene_b() -> SimConfig:
    """Instance B (SampleScene.unity:518-612) — the stock C# defaults."""
    return SimConfig().validate()


# ----------------------------------------------------------------------
# 3D workload presets — the five BASELINE.json configs.
# ----------------------------------------------------------------------

def preset_smoke_box_32() -> SimConfig:
    """32³ smoke box: single dye emitter, 20-iter Jacobi projection."""
    return SimConfig(
        ndim=3,
        size=32,
        time_step=0.05,
        auto_adjust_parameters=False,
        diffusion=0.0,
        viscosity=0.0,
        double_diffuse=False,
        enable_custom_source=True,
        source_strength=120.0,
        source_emits_velocity=True,
        source_velocity=20.0,
        source_radius=2.5,
        source_position=(0.5, 0.15, 0.5),
        enable_obstacle=False,
        obstacle_position=(0.5, 0.5, 0.5),
        jacobi_iters=20,
    ).validate()


def preset_plume_64() -> SimConfig:
    """64³ smoke plume with buoyancy + viscous diffusion solve."""
    return SimConfig(
        ndim=3,
        size=64,
        time_step=0.04,
        auto_adjust_parameters=False,
        diffusion=0.0,
        viscosity=1e-4,
        double_diffuse=False,
        buoyancy=1.0,
        ambient_density=0.0,
        enable_custom_source=True,
        source_strength=150.0,
        source_radius=4.0,
        source_position=(0.5, 0.08, 0.5),
        enable_obstacle=False,
        obstacle_position=(0.5, 0.5, 0.5),
        jacobi_iters=20,
        advect_window=3,
    ).validate()


def preset_vortex_128() -> SimConfig:
    """128³ with vorticity confinement + static solid obstacle."""
    return SimConfig(
        ndim=3,
        size=128,
        time_step=0.03,
        auto_adjust_parameters=False,
        diffusion=0.0,
        viscosity=0.0,
        double_diffuse=False,
        buoyancy=1.0,
        vorticity_confinement=2.0,
        enable_custom_source=True,
        source_strength=150.0,
        source_radius=6.0,
        source_position=(0.5, 0.08, 0.5),
        enable_obstacle=True,
        obstacle_shape=ObstacleShape.CIRCLE,
        obstacle_position=(0.5, 0.45, 0.5),
        obstacle_radius=0.08,
        jacobi_iters=20,
        # Substepped advection: 3 sub-advections of dt/3 with a 1-cell
        # window cover the same 3-cell CFL displacement as one K=3
        # backtrace with 3·27 two-tap terms instead of 343 hat terms.
        advection_scheme="substep",
        advect_window=1,
        advect_substeps=3,
    ).validate()


def preset_multi_emitter_256() -> SimConfig:
    """256³ multi-emitter scene with on-device volumetric raymarch render."""
    return SimConfig(
        ndim=3,
        size=256,
        time_step=0.02,
        auto_adjust_parameters=False,
        diffusion=0.0,
        viscosity=0.0,
        double_diffuse=False,
        buoyancy=0.8,
        vorticity_confinement=1.5,
        enable_custom_source=True,
        source_strength=150.0,
        source_radius=10.0,
        source_position=(0.3, 0.1, 0.3),
        extra_sources=(
            SourceSpec(position=(0.7, 0.1, 0.7), strength=150.0,
                       radius=10.0, emits_velocity=True, velocity=8.0,
                       velocity_dir=(0.0, 1.0, 0.0)),
            SourceSpec(position=(0.7, 0.12, 0.3), strength=100.0,
                       radius=8.0, pulsing=True, pulse_rate=2.0),
        ),
        enable_obstacle=False,
        obstacle_position=(0.5, 0.5, 0.5),
        jacobi_iters=20,
        # 2 × K=1 substeps ≡ the 2-cell CFL envelope of one K=2
        # backtrace, at 2·(two-tap) cost instead of 125 hat terms.
        advection_scheme="substep",
        advect_window=1,
        advect_substeps=2,
    ).validate()


def preset_sharded_512() -> SimConfig:
    """512³ smoke column: the grid the slab-sharded path
    (parallel/sharding.py) splits over a device mesh; its ~2.8 GB state
    also fits one device."""
    return SimConfig(
        ndim=3,
        size=512,
        time_step=0.01,
        auto_adjust_parameters=False,
        diffusion=0.0,
        viscosity=0.0,
        double_diffuse=False,
        buoyancy=0.8,
        enable_custom_source=True,
        source_strength=200.0,
        source_radius=20.0,
        source_position=(0.5, 0.05, 0.5),
        enable_obstacle=False,
        obstacle_position=(0.5, 0.5, 0.5),
        jacobi_iters=20,
        # K=1 × 2 substeps: the two-tap window form covers a 2-cell CFL
        # displacement.
        advection_scheme="substep",
        advect_window=1,
        advect_substeps=2,
    ).validate()


def preset_bench_128() -> SimConfig:
    """The headline benchmark config: 128³, 60-iter Jacobi projection.

    BASELINE.json metric: "steps/sec at 128^3 (60-iter Jacobi)".  The 60
    Jacobi iterations are spent in the pressure projection (the solver's
    dominant cost); diffusion is disabled as is standard for smoke.

    The scene is CFL-bounded by construction: dissipation sinks give the
    plume a bounded steady state and dt is set so the max per-axis
    backtrace displacement stays ≤ 1 cell over a 3000-step run
    (tools/validate_bench_scene.py checks it).
    The advection is therefore the reference's own single unclamped
    semi-Lagrangian backtrace (FluidSim.cs:1523-1576) — exact, never
    window-limited — where the previous scene (dt=0.03, strength 150,
    no sinks: unbounded |v| growth) needed a 2-substep 2-cell envelope
    that still clamped transport.  Per-step solver work is unchanged
    by scene constants; the single backtrace does strictly less
    advection work than the 2-substep arrangement it replaces.
    """
    return SimConfig(
        ndim=3,
        size=128,
        time_step=0.0008,
        auto_adjust_parameters=False,
        diffusion=0.0,
        viscosity=0.0,
        double_diffuse=False,
        buoyancy=0.2,
        enable_custom_source=True,
        source_strength=8.0,
        source_radius=6.0,
        source_position=(0.5, 0.08, 0.5),
        enable_obstacle=False,
        obstacle_position=(0.5, 0.5, 0.5),
        jacobi_iters=60,
        # Single K=1 backtrace — the reference's own advection scheme,
        # exact on this CFL≤1 scene (see docstring).  substeps>1 remain
        # the product answer for fast scenes (vortex128/multi256).
        advection_scheme="substep",
        advect_window=1,
        advect_substeps=1,
        # Stam dissipation sinks (density 1/(1+5·dt), velocity
        # 1/(1+3·dt) per step).
        density_dissipation=5.0,
        velocity_damping=3.0,
    ).validate()


PRESETS = {
    "scene_a": preset_scene_a,
    "scene_b": preset_scene_b,
    "smoke32": preset_smoke_box_32,
    "plume64": preset_plume_64,
    "vortex128": preset_vortex_128,
    "multi256": preset_multi_emitter_256,
    "sharded512": preset_sharded_512,
    "bench128": preset_bench_128,
}


def get_preset(name: str) -> SimConfig:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
