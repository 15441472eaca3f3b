"""nms_roofline.serve: see _common.py."""

from port_bench.metrics._common import nms_roofline as read  # noqa: F401
