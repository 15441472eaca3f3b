"""clouds_per_dispatch.serve: see _common.py."""

from port_bench.metrics._common import clouds_per_dispatch as read  # noqa: F401
