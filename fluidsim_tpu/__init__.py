"""fluidsim_tpu — a stable-fluids framework in JAX.

From-scratch JAX/XLA re-design of the capabilities of
ChrisWangstpauls/3DFluidSimulation (a Unity/C# 2D stable-fluids solver; see
SURVEY.md).  Provides a reference-parity 2D mode and a true 3D voxel engine
with buoyancy/vorticity confinement, sharded across device meshes.
"""

__version__ = "0.1.0"

from .config import (
    ColorMode,
    ObstacleShape,
    SimConfig,
    get_preset,
    PRESETS,
)
from .state import FluidState, zeros_state
from .engine import Engine
from .metrics import MetricsStore
