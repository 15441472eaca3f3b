"""pillars_torch: the PyTorch/CUDA port of pillars_tpu for one NVIDIA H100.

Imports torch and NumPy only, never JAX or the JAX package. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one that raises (no silent CPU
    fallback). ``"cpu"`` must be asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev
