"""mfu.serve: see _common.py."""

from port_bench.metrics._common import mfu as read  # noqa: F401
