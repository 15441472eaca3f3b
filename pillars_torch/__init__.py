"""pillars_torch: the PyTorch/CUDA port of pillars_tpu for one NVIDIA H100.

Imports torch and NumPy only, never JAX or the JAX package. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import functools

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one that raises (no silent CPU
    fallback). ``"cpu"`` must be asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    values, dtype and device and reused after: the host copies a constant to
    the card once, not on every call, so an inference body that a CUDA graph
    captures (pillars_torch/cuda_graph.py) holds no copy from the host. The
    tensor is shared by every caller: read it, never write it."""
    return _constant(_frozen(np.asarray(values).tolist()), dtype,
                     torch.device(device))


def _frozen(values):
    return (tuple(_frozen(v) for v in values) if isinstance(values, list)
            else values)


@functools.lru_cache(maxsize=64)
def _constant(values, dtype: torch.dtype, device: torch.device
              ) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)
