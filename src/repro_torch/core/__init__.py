"""Control-plane types the port's serving layer needs."""

from repro_torch.core.types import SLO  # noqa: F401
