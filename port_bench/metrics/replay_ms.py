"""replay_ms: see _common.py."""

from port_bench.metrics._common import replay_ms as read  # noqa: F401
