"""Fleet control plane: multi-model cluster controller shared by the
discrete-event simulation and the real PyTorch serving path.

``controller`` — ``FleetController``/``FleetPolicy``: the one scaling
                 policy implementation (upscale, scale-to-zero with
                 delayed downscale, predictive prewarming, Alg. 1
                 proactive model distribution);
``frontend``   — ``FleetFrontend``: the real-engine data plane — N
                 registered models over a shared server pool with
                 per-model endpoint lifecycle, request queuing during
                 cold starts, and concurrent contending cold starts.
"""

from repro_torch.fleet.controller import (FleetController, FleetPolicy,
                                          LaunchPlan, PlacementAction)
from repro_torch.fleet.frontend import (FleetFrontend, FleetRequest,
                                        ManagedModel)

__all__ = [
    "FleetController", "FleetPolicy", "LaunchPlan", "PlacementAction",
    "FleetFrontend", "FleetRequest", "ManagedModel",
]
