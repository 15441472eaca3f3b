"""mfu.replay: see _common.py."""

from port_bench.metrics._common import mfu_replay as read  # noqa: F401
