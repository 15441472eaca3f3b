"""clouds_per_s: see _common.py."""

from port_bench.metrics._common import clouds_per_s as read  # noqa: F401
