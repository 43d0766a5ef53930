"""Process groups: one process per rank, the port's counterpart of the
reference's mesh construction (``repro.launch.mesh``).

:func:`init_process_group` starts this process's rank of a
``torch.distributed`` group.  The rendezvous is either the environment
``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) or a
``file://`` store on a shared path (``store_path``); nothing here opens
a rendezvous over the network.  When every rank is on this host (a file
store, or ``LOCAL_WORLD_SIZE == WORLD_SIZE``) the backends' own
bootstrap sockets stay on the loopback interface
(``NCCL_SOCKET_IFNAME=lo``, ``GLOO_SOCKET_IFNAME=lo``) unless the
caller has set them.

NCCL puts rank ``r`` on ``cuda:LOCAL_RANK`` and moves card tensors only;
gloo runs on the CPU.  NCCL with ``device="cpu"``, or gloo on the card,
raises: nothing swaps one backend or device for the other.

:func:`spawn` runs a function in N local processes over a file store in
a temporary directory (the launchers' ``--nprocs N``).
"""

from __future__ import annotations

import datetime
import os
import tempfile
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.comm.distributed import BACKEND_DEVICE, check_backend_device
from repro_torch.device import resolve_device

__all__ = ["ProcessInfo", "init_process_group", "destroy_process_group", "spawn"]

#: how long a collective may wait for its peers before the group fails
DEFAULT_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class ProcessInfo:
    """This process's place in the group."""

    backend: str
    rank: int
    world_size: int
    local_rank: int
    device: torch.device


def _device(backend: str, device, local_rank: int) -> torch.device:
    if device is None:
        device = BACKEND_DEVICE.get(backend, "cpu")
    dev = torch.device(device)
    check_backend_device(backend, dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return resolve_device(dev)


def init_process_group(backend: str = "nccl", device=None, *,
                       store_path: Optional[str] = None, rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> ProcessInfo:
    """Start this process's rank of the default process group.

    ``backend`` is ``"nccl"`` (the card) or ``"gloo"`` (the CPU);
    ``device`` defaults to ``cuda:LOCAL_RANK`` under NCCL and the CPU
    under gloo.  Without ``store_path`` the rank, world size and local
    rank come from the environment (``torchrun``); with it, ``rank`` and
    ``world_size`` are given and every rank is on this host.
    """
    if store_path is None:
        try:
            rank = int(os.environ["RANK"])
            world_size = int(os.environ["WORLD_SIZE"])
        except KeyError:
            raise RuntimeError(
                "no rendezvous: set RANK and WORLD_SIZE (torchrun does) or pass "
                "store_path, rank and world_size"
            ) from None
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        one_host = int(os.environ.get("LOCAL_WORLD_SIZE", world_size)) == world_size
        init_method = "env://"
    else:
        if rank is None or world_size is None:
            raise ValueError("a file store needs rank and world_size")
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        one_host = True
        init_method = "file://" + os.path.abspath(store_path)
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not one of {world_size}")
    dev = _device(backend, device, local_rank)
    if one_host:
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev  # NCCL starts its communicator now, on this card
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return ProcessInfo(backend, rank, world_size, local_rank, dev)


def destroy_process_group() -> None:
    """Tear the default group down (a no-op when none is running)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _entry(rank: int, fn: Callable, nprocs: int, store_path: str, args: tuple) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    fn(rank, nprocs, store_path, *args)


def spawn(fn: Callable, nprocs: int, args: tuple = ()) -> None:
    """Run ``fn(rank, nprocs, store_path, *args)`` in ``nprocs`` new
    processes on this host, over a file store in a temporary directory;
    ``fn`` calls :func:`init_process_group` with ``store_path``.  Raises
    if a process fails (the others are ended)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="repro_torch_store_") as root:
        mp.spawn(_entry, args=(fn, nprocs, os.path.join(root, "store"), args), nprocs=nprocs)
