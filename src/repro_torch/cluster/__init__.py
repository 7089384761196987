"""The simulated cluster the discrete-event ``ServerlessSim`` runs on (copies
of the reference's ``cluster`` modules).

``sim``     — ``EventSim``: the deterministic discrete-event core;
``cluster`` — ``Cluster``: per-server fair-share NICs (``Flow``), per-device
              HBM accounting, host-memory model cache, remote registry.
"""

from repro_torch.cluster.cluster import Cluster, Device, Flow, Server  # noqa: F401
from repro_torch.cluster.sim import Event, EventSim  # noqa: F401
