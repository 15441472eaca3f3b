"""device_idle_frac.latency: see _common.py."""

from port_bench.metrics._common import device_idle_frac as read  # noqa: F401
