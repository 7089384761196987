"""device_idle.serve: the share of the serving window in which neither a
kernel nor a copy ran on the card (torch.profiler)."""

from bench.metrics._common import idle_pct as read  # noqa: F401
