"""Measurement helpers of the port (CUDA events, torch.profiler)."""
