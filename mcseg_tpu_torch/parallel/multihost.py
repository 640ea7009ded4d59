"""The process group of a data-parallel job: one process per card.

The port of the JAX package's ``parallel/multihost.py``. There, one JAX
process per host drives its local chips and ``jax.distributed.initialize``
joins the processes into one global mesh. Here every card has its own
process and ``torch.distributed`` joins them: NCCL between cards, gloo on
the CPU (the tests run n ranks against 1 there). Launch with torchrun,

    torchrun --nproc_per_node 8 -m mcseg_tpu_torch.cli.adapt_train ... --multihost

(``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``), or with one command per process,

    python -m mcseg_tpu_torch.cli.adapt_train ... --coordinator host0:9988 \\
        --num_processes 8 --process_id $RANK

(one command per process; ranks that share a card, which NCCL refuses,
run over gloo with ``MCSEG_DIST_BACKEND=gloo`` in their environment). A
command with neither flag runs in one process on one card, and nothing
here runs. ``--spatial_devices s`` lays the ranks out as (n/s data blocks)
x (s row blocks) (``parallel/spatial.py``). Only rank 0 writes
checkpoints, logs and tables (``is_primary``); ``sync`` is the barrier
after the final checkpoint.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from mcseg_tpu_torch.core.device import resolve_device
from mcseg_tpu_torch.parallel.mesh import DataParallel
from mcseg_tpu_torch.parallel.spatial import check_ranks, spatial_layout


def _card(device: torch.device, rank: int) -> torch.device:
    """The card of this process: ``device`` when it names one, else
    ``cuda:LOCAL_RANK`` (torchrun's), else the rank modulo the cards."""
    if device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None
                        else rank % torch.cuda.device_count())


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               backend: Optional[str] = None, spatial: int = 1) -> DataParallel:
    """Join this process to the job and return its context. ``coordinator``
    ``host:port`` with ``num_processes`` and ``process_id``, or, with all
    three None, torchrun's ``env://`` variables. The backend is NCCL on a
    CUDA device and gloo on the CPU unless ``backend`` names one (gloo also
    carries CUDA tensors, for ranks that share one card). One warm-up
    all-reduce on the device builds the communicator before the first step.
    ``spatial`` > 1 lays the ranks out in row blocks of that many
    (``parallel.spatial.spatial_layout``); a count that does not divide the
    ranks raises before the group is joined. Every failure raises; nothing
    falls back to a single process."""
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already initialized")
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and --process_id")
        init_method, world, rank = f"tcp://{coordinator}", num_processes, process_id
    else:
        if num_processes is not None or process_id is not None:
            raise ValueError("--num_processes and --process_id need --coordinator")
        init_method, world, rank = "env://", None, None
    if world is not None or "WORLD_SIZE" in os.environ:
        check_ranks(spatial, world if world is not None else int(os.environ["WORLD_SIZE"]))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        dev = _card(dev, process_id if process_id is not None
                    else int(os.environ.get("RANK", "0")))
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world or -1,
                            rank=rank if rank is not None else -1, **kw)
    dp = DataParallel(rank=dist.get_rank(), world=dist.get_world_size(), device=dev)
    try:
        warm = torch.ones(1, device=dev)
        dist.all_reduce(warm)
        if int(warm.item()) != dp.world:
            raise RuntimeError(f"warm-up all-reduce gave {warm.item()}, not {dp.world}")
        return spatial_layout(dp, spatial)
    except BaseException:
        shutdown()
        raise


def shutdown() -> None:
    """Leave the job (``destroy_process_group``), if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def maybe_initialize_from_args(args, device="cuda") -> Iterator[Optional[DataParallel]]:
    """The entry points' hook: with ``--multihost`` or ``--coordinator``,
    join the job for the duration of the block and yield its context;
    without them yield None and do nothing (``--num_processes`` or
    ``--process_id`` alone raise: they ask for a job that nothing joins, and
    so does ``--spatial_devices`` above 1: one process has no rows to
    split). ``--spatial_devices`` lays out the job's ranks."""
    if not (getattr(args, "multihost", False) or getattr(args, "coordinator", None)):
        if getattr(args, "num_processes", None) is not None \
                or getattr(args, "process_id", None) is not None:
            raise ValueError("--num_processes and --process_id need --coordinator")
        check_ranks(getattr(args, "spatial_devices", 1), 1)
        yield None
        return
    dp = initialize(args.coordinator, args.num_processes, args.process_id, device,
                    backend=os.environ.get("MCSEG_DIST_BACKEND") or None,
                    spatial=getattr(args, "spatial_devices", 1))
    try:
        yield dp
    finally:
        shutdown()


def is_primary() -> bool:
    """True on the process that writes checkpoints, logs and tables: rank 0,
    or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def sync() -> None:
    """Barrier across the processes (a no-op in one process): no process
    leaves while rank 0 is still writing the final checkpoint."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
