"""latency_p95_ms: see _common.py."""

from port_bench.metrics._common import latency_p95_ms as read  # noqa: F401
