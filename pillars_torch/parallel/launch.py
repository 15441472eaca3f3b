"""Starting the ranks: one process per device, as the port runs what the JAX
package runs in one process over N devices.

- :func:`spawn` starts ``world_size`` processes with ``torch.multiprocessing``
  (the ``spawn`` start method), joins them into one process group through a
  file in a fresh temporary directory, calls ``fn(rank, device, *args)`` in
  each and tears the group down. A rank that raises stops the others, and
  ``spawn`` raises.
- :func:`init_from_env` joins the process group that ``torchrun`` describes
  in the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ...). Its
  caller tears the group down: drop the captured callables first (the
  ``Trainer``, the steps, the inference functions; ``gc.collect()``), since
  NCCL's teardown waits until every CUDA graph that holds its collectives
  is destroyed.

The backend follows the device: NCCL for ``cuda``, one card per rank (the
rank's ``cuda:<rank>``), asking for more cards than exist raises; gloo for
``cpu``. ``backend="gloo"`` with ``device="cuda"`` runs several ranks on ONE
card (NCCL refuses two ranks on one device): gloo moves the CUDA tensors of
its collectives through host memory.
"""

from __future__ import annotations

import datetime
import gc
import os
import shutil
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, rank: int, backend: str) -> torch.device:
    """The device of ``rank``: the CPU, the rank's own card under NCCL, or
    the one card that every gloo rank shares."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank if backend == "nccl" else
                        (dev.index or 0))


def check_devices(world_size: int, device, backend: str):
    """Raises where the ranks cannot each have what they ask for."""
    if torch.device(device).type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(
            f"{world_size} NCCL ranks need {world_size} cards; "
            f"{torch.cuda.device_count()} are visible")


def _entry(rank, fn, world_size, backend, init_method, device, threads,
           args):
    if threads:
        torch.set_num_threads(threads)
    dev = rank_device(device, rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, timeout=TIMEOUT)
    try:
        fn(rank, dev, *args)
    except BaseException:
        if backend != "nccl":  # see below; the failed frames hold graphs
            dist.destroy_process_group()
        raise
    # NCCL's teardown waits until every CUDA graph that holds its
    # collectives is destroyed: free the captured callables that ``fn``
    # left in reference cycles first, or the rank never exits. A rank that
    # raised leaves its communicators to the process's exit instead.
    gc.collect()
    dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: tuple = (), device="cpu",
          backend: Optional[str] = None, threads: int = 0):
    """Run ``fn(rank, device, *args)`` in ``world_size`` new processes
    joined into one process group; returns when all have returned.
    ``fn`` must be importable by name (a module-level function of a module
    that the children can import). ``threads``: torch's intra-op threads
    per rank (0: torch's default)."""
    import torch.multiprocessing as mp

    backend = backend or backend_for(device)
    check_devices(world_size, device, backend)
    tmp = tempfile.mkdtemp(prefix="pillars_torch_ranks_")
    try:
        mp.start_processes(
            _entry, args=(fn, world_size, backend,
                          f"file://{os.path.join(tmp, 'init')}", device,
                          threads, tuple(args)),
            nprocs=world_size, join=True, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def init_from_env(device=None) -> torch.device:
    """Join the process group described by ``torchrun``'s environment;
    returns this rank's device (its ``LOCAL_RANK`` card under NCCL)."""
    device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    backend = backend_for(device)
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = rank_device(device, local, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    return dev


def is_main() -> bool:
    """True on rank 0, and in a process outside any process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def resolve_num_devices(num_devices: int) -> int:
    """``runtime.num_devices`` as the library reads it: 0 means every rank
    of the process group, or one device outside any group. Only a launcher
    reads 0 as every visible card (:func:`visible_devices`), before it
    starts the ranks."""
    if num_devices:
        return num_devices
    return dist.get_world_size() if dist.is_initialized() else 1


def visible_devices(device) -> int:
    """The ranks that ``runtime.num_devices`` 0 asks a launcher for: one per
    visible card, or one on the CPU."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1
