"""Data parallelism across processes on torch.distributed (PyTorch port of
ubteacher_tpu.parallel.mesh).

The JAX package runs one program over a device mesh: SOLVER.IMG_PER_BATCH_*
are the global batch, GSPMD shards its rows over the `data` axis, and the
sums behind every loss normalizer are global because the batch is. The port
runs one process per card (detectron2's layout, reference train_net.py:
66-73) and keeps those semantics:

  * the batch sizes stay global; rank r of N owns rows [r*B/N, (r+1)*B/N)
    of each stream, in rank order, as `mesh.py:shard_batch` lays them out
    (`owned_rows`); a batch that N does not divide raises;
  * random draws (strong augmentation, R-CNN sampling) are taken for the
    global batch from the same seeded generator on every rank, and each rank
    keeps its own rows (`take_owned`), so a rank's rows get exactly the
    values one process gives them.

The rule for losses and gradients, applied at every normalizer: each rank's
loss is its share of the global loss, the numerator over its own rows
divided by the global denominator (`all_reduce_sum` of the count, which
carries no gradient; branches taken on a count take it on the global one),
and gradients are summed over the ranks (`reduce_gradients`, after
backward(), before optimizer.step()). So every rank holds the gradient of
the global loss and applies the same update; parameters start identical
(`broadcast_module` from rank 0). Metrics follow the same rule: losses are
shares and counts are local counts, so their sums over the ranks (one
all_reduce a step) are the global figures.

The gradients are reduced explicitly, not by DistributedDataParallel: DDP
arms its reducer only when the forward goes through the wrapper, and the
R-CNN step calls the backbone, the RPN and the box head one by one.

Without a process group every collective here does nothing, so one process
runs exactly as it did; with one (a world of one included) the collectives
run on its backend: nccl on the card, gloo on the CPU, or gloo on the card
when several ranks share one card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.events import span

# seconds a collective (and the rendezvous) waits for the other ranks before
# it fails the run: a rank that died must not hang the others
DEFAULT_TIMEOUT = 600.0


def default_backend(device_type: str) -> str:
    """nccl for ranks on cards, gloo for ranks on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def init_distributed(backend: str, init_method: str, world_size: int, rank: int,
                     timeout: float = DEFAULT_TIMEOUT) -> None:
    """init_process_group and one warm-up collective right after it (the
    counterpart of mesh.py:distributed_init): the ranks meet at the
    rendezvous, and the backend's communicator is built while they are still
    in step, not at a first collective behind minutes of per-rank skew.
    With nccl the rank's card is `LOCAL_RANK`'s."""
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    warm = torch.ones(1, device=_collective_device())
    dist.all_reduce(warm)
    if warm.item() != world_size:
        raise RuntimeError(f"warm-up all_reduce gave {warm.item()}, expected {world_size}")


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def local_rank() -> int:
    """The rank's index among the processes of its machine (its card)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def is_main_process() -> bool:
    return rank() == 0


def owned_rows(n: int, index: Optional[int] = None, count: Optional[int] = None) -> slice:
    """The rows [index*n/count, (index+1)*n/count) of a global batch of n
    that rank `index` of `count` owns (default: this process's); a batch
    that `count` does not divide raises."""
    count = world_size() if count is None else count
    index = rank() if index is None else index
    if n % count:
        raise ValueError(f"batch size {n} not divisible by the {count} processes")
    chunk = n // count
    return slice(index * chunk, (index + 1) * chunk)


def take_owned(x: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
    """x's leading axis is global blocks of sizes `blocks` (each a stream's
    global batch, in order); -> this rank's rows of each block, in order:
    the rows that match its local batch."""
    if world_size() == 1:
        return x
    parts, start = [], 0
    for n in blocks:
        own = owned_rows(n)
        parts.append(x[start + own.start:start + own.stop])
        start += n
    if start != x.shape[0]:
        raise ValueError(f"blocks {list(blocks)} do not cover {x.shape[0]} rows")
    return parts[0] if len(parts) == 1 else torch.cat(parts, 0)


def _collective_device() -> torch.device:
    """Where a collective's buffers live: the rank's card under nccl, the
    CPU otherwise (gloo reduces CUDA tensors but gathers only CPU ones)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, detached (a loss normalizer or a count:
    no gradient flows through it). Without a process group: `x` itself."""
    if not is_distributed():
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out


def reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum the parameters' gradients over the ranks, in place, through one
    flat all_reduce. Parameters without a gradient stay without one (the
    ranks run one graph, so they agree on which those are). Timed as the
    step's `ubt.step.grad_allreduce` span."""
    if not is_distributed():
        return
    with span("ubt.step.grad_allreduce"):
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]), grads)])


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Rank `src`'s parameters and buffers on every rank."""
    if not is_distributed():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src)


def barrier() -> None:
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def allgather_host_rows(rows: np.ndarray) -> np.ndarray:
    """Concatenate every rank's host (n_r, d) rows, in rank order (the
    evaluation gather, mesh.py:162-194). Counts may differ and be 0: rows
    are padded to the largest count, gathered and unpadded. With one process
    the rows come back as they are."""
    rows = np.asarray(rows)
    if rows.ndim == 1:
        rows = rows.reshape(0, 1) if rows.size == 0 else rows[:, None]
    n = world_size()
    if n == 1:
        return rows
    device = _collective_device()
    count = torch.tensor([rows.shape[0]], dtype=torch.int64, device=device)
    counts = [torch.zeros_like(count) for _ in range(n)]
    dist.all_gather(counts, count)
    counts = [int(c.item()) for c in counts]
    mx = max(counts)
    if mx == 0:
        return rows
    pad = np.zeros((mx, rows.shape[1]), rows.dtype)
    pad[: rows.shape[0]] = rows
    mine = torch.from_numpy(pad).to(device)
    gathered = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(gathered, mine)
    return np.concatenate([g[:c].cpu().numpy() for g, c in zip(gathered, counts)])


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(local: int, main: Callable, args: tuple, world: int, num_gpus: int, machine_rank: int,
            dist_url: str, backend: str, timeout: float) -> None:
    os.environ["LOCAL_RANK"] = str(local)
    init_distributed(backend, dist_url, world, machine_rank * num_gpus + local, timeout)
    try:
        main(*args)
    finally:
        dist.destroy_process_group()


def launch(main: Callable, num_gpus: int, num_machines: int = 1, machine_rank: int = 0,
           dist_url: str = "auto", backend: Optional[str] = None, args: tuple = (),
           timeout: float = DEFAULT_TIMEOUT):
    """Run `main(*args)` on num_gpus * num_machines ranks (detectron2's
    launch): this machine spawns num_gpus processes, ranks machine_rank *
    num_gpus + i, each with LOCAL_RANK i, which meet at `dist_url`
    (tcp://host:port; "auto": a free localhost port, one machine only).
    `backend` defaults to nccl when a card is visible, else gloo. One rank
    and no backend asked for: `main` runs in this process without a process
    group, as a plain run does. A rank that raises, or whose peers stop
    answering for `timeout` seconds, fails the launch."""
    world = num_gpus * num_machines
    if world < 1:
        raise ValueError(f"--num-gpus {num_gpus} x --num-machines {num_machines}: no ranks")
    if world == 1 and backend is None:
        return main(*args)
    if dist_url == "auto":
        if num_machines != 1:
            raise ValueError("dist_url 'auto' picks a localhost port: give --dist-url for several machines")
        dist_url = f"tcp://127.0.0.1:{free_port()}"
    backend = backend or default_backend("cuda" if torch.cuda.is_available() else "cpu")
    import torch.multiprocessing as mp

    mp.start_processes(_worker, args=(main, args, world, num_gpus, machine_rank, dist_url, backend, timeout),
                       nprocs=num_gpus, start_method="spawn")
    return None
