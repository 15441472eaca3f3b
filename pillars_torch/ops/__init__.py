"""Tensor ops of the port: voxelizer, anchors, NMS and its CUDA kernel."""
