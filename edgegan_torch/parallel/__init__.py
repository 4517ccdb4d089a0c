"""Data parallelism over torch.distributed: one process per rank (the JAX
package's parallel/__init__.py).

The JAX package runs data parallelism as one jitted program over a 1-D
device mesh: the batch sharded, the parameters replicated, and XLA
inserting the reductions. The port makes the same semantics explicit, in
processes that `torchrun` (`python -m torch.distributed.run`) starts,
one per rank:

- the parameters are replicated: rank 0's state is broadcast after init
  or restore (`broadcast_`), and each optimizer group's gradients are
  averaged over the ranks before its update (`all_reduce_mean_`), so
  every rank applies the same update;
- each rank takes its contiguous rows of the global batch (`local_rows`);
- losses stay local means: with equal shards the mean of the ranks'
  gradients is the gradient of the global mean, and while
  `synced_batch_stats()` is active the batch-norm statistics span the
  ranks (`sum_across`, differentiable to any order), as GSPMD's do.

Backends: NCCL where every rank has a card of its own, gloo on the CPU
and where ranks share a card (`EDGEGAN_RANKS_PER_CARD=k` puts ranks
LOCAL_RANK // k on one card; NCCL refuses two ranks on one device).
Device tensors meet only all_reduce, broadcast and barrier, the
collectives gloo takes for CUDA tensors. Every collective has a timeout
(`EDGEGAN_DIST_TIMEOUT` seconds, default 600), so that a rank that falls
out of step fails instead of hanging; nothing falls back to fewer ranks.

Without a launcher (no WORLD_SIZE in the environment) no group is made
and every function here is a no-op. Under a launcher with one rank the
group is made (NCCL on a card) and the collectives run, giving their
inputs back unchanged, while the rows and the batch-norm statistics stay
this rank's: the numerics are those of the one-process path.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import threading
from typing import List, Sequence

import torch
import torch.distributed as dist

# the start-up barrier waits for local rank 0's kernel build (nvcc)
BUILD_TIMEOUT_S = 1800.0
_local = threading.local()


def timeout_s() -> float:
    """Seconds a collective waits for its peers (EDGEGAN_DIST_TIMEOUT)."""
    return float(os.environ.get('EDGEGAN_DIST_TIMEOUT', '600'))


def launched_world_size() -> int:
    """The number of ranks the launcher started (torchrun's WORLD_SIZE)."""
    return int(os.environ.get('WORLD_SIZE', '1'))


def local_rank() -> int:
    return int(os.environ.get('LOCAL_RANK', '0'))


def ranks_per_card() -> int:
    return int(os.environ.get('EDGEGAN_RANKS_PER_CARD', '1'))


def initialized() -> bool:
    """True in a process group (a launcher started this process)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def active() -> bool:
    """True in a process group of two or more ranks."""
    return world_size() > 1


def is_process_zero() -> bool:
    """True on the rank that owns host-side writes: stdout, metrics.jsonl,
    TensorBoard and checkpoints."""
    return rank() == 0


def _device(kind: str, gpu: str) -> torch.device:
    if kind == 'cpu':
        return torch.device('cpu')
    if kind != 'cuda':
        raise ValueError(f'unknown device kind {kind!r}')
    if 'LOCAL_RANK' not in os.environ:
        return torch.device(f'cuda:{gpu}')
    index = local_rank() // ranks_per_card()
    count = torch.cuda.device_count()
    if index >= count:
        raise SystemExit(
            f'rank {os.environ.get("RANK")}: no card cuda:{index} '
            f'({count} visible, EDGEGAN_RANKS_PER_CARD='
            f'{ranks_per_card()})')
    return torch.device(f'cuda:{index}')


def init(kind: str = 'cuda', gpu: str = '0', enabled: bool = True
         ) -> torch.device:
    """Join the process group torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this rank's device:
    `cuda:<LOCAL_RANK // EDGEGAN_RANKS_PER_CARD>` under a launcher,
    `cuda:<gpu>` without one, or the CPU for `kind='cpu'`.

    Under a launcher, local rank 0 builds the CUDA kernels while
    the others wait at a barrier (so that no rank's first collective
    runs into a peer's nvcc build, and no two ranks build), then one
    tiny all-reduce creates the communicators while the ranks are in
    step (`warm_collectives`). `enabled=False` (Config.data_parallel
    off) makes no group and refuses two or more ranks. Rank 0 prints the
    backend."""
    world = launched_world_size()
    if world > 1 and not enabled:
        raise SystemExit(f'data_parallel is off but {world} ranks were '
                         'launched: run one process')
    device = _device(kind, gpu)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    if not enabled or 'WORLD_SIZE' not in os.environ or initialized():
        return device
    backend = ('gloo' if device.type == 'cpu' or ranks_per_card() > 1
               else 'nccl')
    dist.init_process_group(
        backend, init_method='env://', world_size=world,
        rank=int(os.environ['RANK']),
        timeout=datetime.timedelta(seconds=timeout_s()))
    if is_process_zero():
        print(f' [*] data parallel: {world} ranks over {backend}, rank 0 '
              f'on {device}', flush=True)
    if device.type == 'cuda':
        if local_rank() == 0:
            from ..ops import _build
            _build.build()
        barrier('kernels built', max(timeout_s(), BUILD_TIMEOUT_S))
    barrier('started')
    warm_collectives(device)
    return device


def shutdown():
    """Leave the process group, if one was made."""
    if initialized():
        dist.destroy_process_group()


def barrier(name: str, timeout: float = None):
    """Wait until every rank is here, at most `timeout` seconds (the
    collective timeout by default); on gloo the error names the ranks
    that did not come."""
    if not initialized():
        return
    t = datetime.timedelta(seconds=timeout or timeout_s())
    try:
        if dist.get_backend() == 'gloo':
            dist.monitored_barrier(timeout=t)
        else:
            dist.barrier(device_ids=[torch.cuda.current_device()])
    except RuntimeError as e:
        raise RuntimeError(f'barrier {name!r} failed: {e}') from e


def warm_collectives(device):
    """One tiny all-reduce on `device`, waited for, so that the
    communicators are made now, while the ranks are in step (the JAX
    package's warm_collectives, l.97)."""
    if not initialized():
        return
    t = torch.ones(1, device=device)
    dist.all_reduce(t)
    if t.item() != world_size():
        raise RuntimeError(f'warm-up all-reduce gave {t.item()}')


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous rows of a global batch (leading axis)."""
    if not active():
        return x
    n, w = x.shape[0], world_size()
    if n % w:
        raise ValueError(f'batch of {n} rows over {w} ranks')
    return x.narrow(0, rank() * (n // w), n // w)


def _buckets(tensors: Sequence[torch.Tensor]):
    """Tensors grouped by (device, dtype): one flat bucket each."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    return groups.values()


def _flat_collective(tensors: Sequence[torch.Tensor], op):
    """Apply `op` (an in-place collective on one flat tensor) to every
    tensor of `tensors`, one bucket per device and dtype."""
    for group in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        offset = 0
        with torch.no_grad():
            for t in group:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n


def all_reduce_sum_(tensors: List[torch.Tensor]):
    """Replace each tensor by its sum over the ranks, in place: one flat
    all-reduce per device and dtype. Every rank gets the same bits."""
    if initialized() and tensors:
        _flat_collective(tensors, dist.all_reduce)


def all_reduce_mean_(tensors: List[torch.Tensor]):
    """Replace each tensor by its mean over the ranks, in place (the sum
    divided by the world size)."""
    if not initialized() or not tensors:
        return
    w = world_size()

    def op(flat):
        dist.all_reduce(flat)
        flat.div_(w)
    _flat_collective(tensors, op)


def broadcast_(tensors: List[torch.Tensor], src: int = 0):
    """Overwrite each tensor with rank `src`'s, in place: one flat
    broadcast per device and dtype."""
    if not initialized() or not tensors:
        return
    _flat_collective(tensors, lambda flat: dist.broadcast(flat, src))


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s `obj` (a small picklable host object) on every rank."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


class _SumAcross(torch.autograd.Function):
    """Sum over the ranks. Its backward is the same sum of the incoming
    gradients (each rank's input reaches every rank's output), written
    with this Function, so that a backward with create_graph (the
    gradient penalty's) stays differentiable."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return _SumAcross.apply(g)


def sum_across(x: torch.Tensor) -> torch.Tensor:
    """Differentiable elementwise sum of `x` over the ranks."""
    if not active():
        return x
    return _SumAcross.apply(x)


@contextlib.contextmanager
def synced_batch_stats():
    """While active in this thread, batch norm takes its statistics over
    every rank's rows. The training step, the test forward and the served
    batch enter it: calls that every rank makes. A forward that one rank
    makes alone (the summaries' sample forward on rank 0) stays outside,
    since a collective there would wait for ever."""
    before = getattr(_local, 'sync', False)
    _local.sync = True
    try:
        yield
    finally:
        _local.sync = before


def batch_stats_synced() -> bool:
    return active() and getattr(_local, 'sync', False)
