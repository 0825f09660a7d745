"""Process-group glue: joining a job, rank-0 gating, replication, gathers.

Counterpart of enerf_tpu/parallel/multihost.py, in torch.distributed's
idiom:

  - `initialize()` wraps `torch.distributed.init_process_group`.  Without
    arguments it joins the job that torchrun started (`env://`: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT); with them, a `file://` or
    `tcp://` rendezvous.  Unlike the JAX package, which carries on as one
    process when its runtime does not come up, it raises: a data-parallel
    run that silently trains on one process is a different run.
  - `is_primary()`, `rank()`, `world_size()`: process 0 writes the files.
  - `replicate_from_host(tensors)`: broadcast from rank 0, then
    `assert_replicated` checks every rank holds the same bits.
  - JAX's `host_local_batch_to_global` has no counterpart: each rank's batch
    *is* its shard of the global batch, which is the concatenation of the
    ranks' batches in rank order.  What has to be global (the eval image,
    the error map's per-ray losses and cells) goes through `gather_rows`.
  - `all_processes_barrier(name)`.

Every collective here is an all_reduce or a broadcast, so one code path
serves NCCL (a card per rank) and gloo (CPU ranks, or ranks placed on one
card on purpose; gloo may not gather CUDA tensors).
"""

import datetime
import os

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(init_method=None, world_size=None, rank=None, backend=None,
               timeout=DEFAULT_TIMEOUT):
    """Join the process group (idempotent).  With no `init_method`, the
    torchrun environment (`env://`), which must be complete; `backend`
    defaults to gloo.  Raises on any failure: there is no single-process
    fallback."""
    if dist.is_initialized():
        return
    if init_method is None:
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                "joining a data-parallel job needs the environment torchrun sets "
                f"(python -m torch.distributed.run ...); missing {', '.join(missing)}")
        init_method = "env://"
    kwargs = {} if world_size is None else {"world_size": world_size, "rank": rank}
    dist.init_process_group(backend=backend or "gloo", init_method=init_method,
                            timeout=timeout, **kwargs)


def local_rank():
    """This process's index on its host (torchrun's LOCAL_RANK; else the rank)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary():
    return rank() == 0


def all_processes_barrier(name="barrier"):
    """Wait for every rank (no-op on one process).  `name` labels the wait in
    a timeout's error."""
    if world_size() == 1:
        return
    try:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def gather_rows(x, group=None):
    """[n, ...] rows of every rank -> [world * n, ...] in rank order, on every
    rank: an all_reduce SUM into zeros at this rank's offset (exact: each
    entry is one rank's value plus zeros).  Every rank passes the same n."""
    world = dist.get_world_size(group)
    r = dist.get_rank(group)
    is_bool = x.dtype == torch.bool
    x = x.to(torch.uint8) if is_bool else x
    out = x.new_zeros((world * x.shape[0],) + tuple(x.shape[1:]))
    out[r * x.shape[0]:(r + 1) * x.shape[0]] = x
    dist.all_reduce(out, group=group)
    return out.bool() if is_bool else out


def _bits(x):
    """The tensor's bits as a flat int32 tensor (equal iff bit-equal)."""
    x = x.detach().contiguous().reshape(-1)
    if x.element_size() == 1:
        return x.view(torch.uint8).to(torch.int32)
    if x.element_size() == 2:
        return x.view(torch.int16).to(torch.int32)
    return x.view(torch.int32)


def assert_replicated(tensors, group=None, what="state"):
    """Raise on every rank unless every rank holds bit-equal `tensors` (a
    dict of name -> tensor, in the same order on every rank): one all_reduce
    MAX of each tensor's bits, then one of the mismatch flag."""
    differ = []
    for name, x in tensors.items():
        bits = _bits(x)
        top = bits.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        if not torch.equal(top, bits):
            differ.append(name)
    dev = next(iter(tensors.values())).device if tensors else torch.device("cpu")
    flag = torch.tensor([len(differ)], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    if int(flag):
        raise RuntimeError(f"ranks disagree on the replicated {what}: rank {dist.get_rank()} "
                           f"differs in {differ or 'nothing (another rank does)'}")


@torch.no_grad()
def replicate_from_host(tensors, group=None):
    """Broadcast each of `tensors` (dict name -> tensor, same order on every
    rank) from rank 0 of the job in place, then check the ranks agree.
    Returns it."""
    for x in tensors.values():
        dist.broadcast(x.view(torch.uint8) if x.dtype == torch.bool else x, 0, group=group)
    assert_replicated(tensors, group, "values after the broadcast")
    return tensors
