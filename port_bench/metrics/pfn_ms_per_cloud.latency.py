"""pfn_ms_per_cloud.latency: see _common.py."""

from port_bench.metrics._common import pfn_ms_per_cloud as read  # noqa: F401
