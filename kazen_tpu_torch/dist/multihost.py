"""Multi-process initialization (SURVEY §5 'Distributed communication
backend').

The port of ``kazen_tpu/dist/multihost.py`` on torch.distributed. Each
process runs the same program: ``initialize`` joins the process group
(``nccl`` for the card, ``gloo`` for CPU tensors), and the scene is built
identically in every process from the same description, so nothing is
broadcast. The process group takes the place of the reference's global
mesh: dist/sharding.py reduces films and gradients over it, and a rank owns
the lanes ``local_lane_slice`` gives it.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """``nccl`` for CUDA tensors, ``gloo`` for CPU tensors."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address=None, num_processes=None, process_id=None, device="cuda"):
    """Join the process group of ``num_processes`` processes whose rank 0
    listens at ``coordinator_address`` ("host:port"); nothing for a single
    process, as the reference. On CUDA each rank takes the card of its rank
    modulo the cards of its host."""
    if num_processes is None or num_processes <= 1:
        return
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend_for(device), init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )


def rank_and_size(group=None):
    """(rank, world size) in ``group`` (the default group), or (0, 1) when
    no process group is initialized."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def local_lane_slice(n_lanes: int, group=None):
    """The [start, stop) lane range this process owns: equal slices of
    ceil(n_lanes / world size) lanes, the last one shorter."""
    rank, size = rank_and_size(group)
    per = -(-n_lanes // size)
    return min(rank * per, n_lanes), min((rank + 1) * per, n_lanes)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ensure_group(device) -> bool:
    """A process group for this process: the one already initialized, one
    from the environment (torchrun's MASTER_ADDR, MASTER_PORT, RANK and
    WORLD_SIZE), or else a group of this process alone on a free local
    port. Returns whether it initialized one (which the caller then
    destroys)."""
    if dist.is_initialized():
        return False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        rank = int(os.environ["RANK"])
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
        dist.init_process_group(backend_for(device), init_method="env://")
        return True
    dist.init_process_group(
        backend_for(device), init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
    )
    return True
