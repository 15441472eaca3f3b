"""kernels_per_cloud.serve: see _common.py."""

from port_bench.metrics._common import kernels_per_cloud as read  # noqa: F401
