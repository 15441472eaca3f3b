"""setup_s: see _common.py."""

from port_bench.metrics._common import setup_s as read  # noqa: F401
