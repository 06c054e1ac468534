"""Process set-up and per-rank data (port of kalle_tpu/parallel/multihost.py).

One process per device. `initialize` joins the process group: torchrun's
RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT (env://), or an explicit
init method, rank and world size. Every process runs the same program
and reads its own data shard (`OfflineLatentDataset(shard_index=dp rank,
shard_count=dp size)`, `mesh.data_shard`).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, device: str = "cuda") -> None:
    """Join the process group: NCCL for device "cuda" (each process on the
    card of its LOCAL_RANK), gloo for "cpu". A no-op when the group is
    already initialized, or when neither an init method nor torchrun's
    environment is given (a single process)."""
    if dist.is_initialized():
        return
    if init_method is None and "MASTER_ADDR" not in os.environ:
        return
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kw = {} if init_method is None else {"world_size": world_size, "rank": rank}
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=init_method or "env://", **kw)


def process_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_main_process() -> bool:
    """accelerator.is_main_process equivalent (ref train_offline.py:262)."""
    return process_info()[0] == 0


def barrier() -> None:
    """accelerator.wait_for_everyone equivalent (ref train_offline.py:259)."""
    if dist.is_initialized():
        dist.barrier()


def host_local_to_global(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """In SPMD torch a rank's rows already are its shard of the global batch
    (their concatenation along the row dimension: 0, or 1 for (A, B, ...)
    microbatch stacks): no copy. Checks that every dp rank holds a batch of
    the same shapes."""
    from .mesh import DP_AXIS

    group = mesh.group(DP_AXIS)
    for k, v in batch.items():
        if not hasattr(v, "shape"):
            continue
        mine = torch.tensor(list(v.shape) + [v.dim()], dtype=torch.long, device=mesh.device)
        width = torch.tensor([mine.numel(), -mine.numel()], device=mesh.device)
        dist.all_reduce(width, op=dist.ReduceOp.MAX, group=group)  # (max, -min)
        if int(width[0]) != -int(width[1]):
            raise ValueError(f"{k}: dp ranks hold arrays of different ranks")
        hi, lo = mine.clone(), mine.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        if not torch.equal(hi, lo):
            raise ValueError(f"{k}: dp ranks hold shapes from {lo.tolist()[:-1]} to "
                             f"{hi.tolist()[:-1]}")
    return batch
