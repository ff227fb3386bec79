"""Data parallelism: one process per card under ``torch.distributed``
(counterpart of pemp_tpu/parallel/mesh.py).

The JAX package trains on a 1-D ``data`` mesh: the batch sharded on
``P("data")``, the state replicated, and under ``jit`` every reduction of
the step spans the whole batch. Here each process (a rank) holds the
contiguous rows ``[r B / W, (r + 1) B / W)`` of each global batch of B
images, as ``P("data")`` gives device r of W, and the step computes what
one process computes on the global batch:

* the BatchNorm moments (``MaskedBatchNorm``, the backbone's BatchNorm in
  training mode) are sums over the ranks (:func:`global_moments`, through
  :func:`global_sum`, whose backward is again a sum over the ranks);
* each loss is the rank's numerator over the global denominator
  (:func:`global_count`), so the ranks' losses sum to the global batch's;
* after the backward one all-reduce sums the gradients, the logged loss
  and its parts and the non-finite flags (:func:`all_sum_flat`), so every
  rank takes the same update or every rank skips it.

:func:`init` reads the launch from the environment: torchrun's ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``;
Slurm's ``SLURM_PROCID``, ``SLURM_NTASKS`` and ``SLURM_LOCALID``; Open
MPI's ``OMPI_COMM_WORLD_RANK``, ``_SIZE`` and ``_LOCAL_RANK``; or
``PMI_RANK`` and ``PMI_SIZE``. A launch with none of them, or a world of
1 outside torchrun, is a plain process with no group, and every helper
here is then the identity. Unlike ``maybe_init_distributed``, which prints
and goes on as one process when ``jax.distributed.initialize()`` fails, a
failed initialisation raises: nothing falls back.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import multiprocessing
import os
import re
import time

import numpy as np
import torch
import torch.distributed as dist

# how long a collective waits for the other ranks before it raises, so that
# a rank that dies does not hang the rest for ever
DEFAULT_TIMEOUT_S = 600.0
DEFAULT_PORT = 29500

# (launcher, rank, world size, local rank) variables, in the JAX function's
# order of precedence after torchrun's
_LAUNCHERS = (
    ("slurm", "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),
    ("openmpi", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK"),
    ("pmi", "PMI_RANK", "PMI_SIZE", "MPI_LOCALRANKID"),
)


def _first_host(nodelist: str) -> str:
    """The first host of a Slurm node list (``gpu[03-04,07],cpu1`` ->
    ``gpu03``)."""
    m = re.match(r"([^,\[]+)(?:\[([^\]]+)\])?", nodelist)
    if m is None:
        raise ValueError(f"cannot read the Slurm node list {nodelist!r}")
    name, ranges = m.groups()
    return name + (ranges.split(",")[0].split("-")[0] if ranges else "")


def launch_env(env=None) -> dict | None:
    """The launch the environment describes: ``{"launcher", "rank",
    "world", "local_rank", "addr", "port"}``, or None for a plain process
    (no launcher's variables, or a world of 1 outside torchrun). The
    rendezvous address is ``MASTER_ADDR`` (under Slurm the first host of the
    step's node list when unset) and the port ``MASTER_PORT`` (29500 when
    unset); raises where a world of several processes names no address."""
    env = os.environ if env is None else env
    if "RANK" in env and "WORLD_SIZE" in env:
        launch = {"launcher": "torchrun", "rank": int(env["RANK"]),
                  "world": int(env["WORLD_SIZE"]), "local_rank": int(env.get("LOCAL_RANK", 0))}
    else:
        for launcher, rank, size, local in _LAUNCHERS:
            if size in env:
                break
        else:
            return None
        if int(env[size]) <= 1:
            return None
        if local not in env and launcher == "pmi":
            local = "PMI_LOCAL_RANK"
        if local not in env:
            raise ValueError(f"{launcher} launch: {local} is not set, so the rank's card is "
                             f"unknown")
        launch = {"launcher": launcher, "rank": int(env[rank]), "world": int(env[size]),
                  "local_rank": int(env[local])}
    addr = env.get("MASTER_ADDR")
    if addr is None and launch["launcher"] == "slurm":
        nodes = env.get("SLURM_STEP_NODELIST") or env.get("SLURM_JOB_NODELIST")
        addr = _first_host(nodes) if nodes else None
    if addr is None:
        if launch["world"] > 1:
            raise ValueError(f"{launch['launcher']} launch of {launch['world']} processes: "
                             f"set MASTER_ADDR (and MASTER_PORT) to rank 0's host")
        addr = "localhost"
    launch["addr"] = addr
    launch["port"] = int(env.get("MASTER_PORT", DEFAULT_PORT))
    if not 0 <= launch["rank"] < launch["world"]:
        raise ValueError(f"rank {launch['rank']} outside a world of {launch['world']}")
    return launch


def init(device="cuda", *, launch=None, backend=None, init_method=None,
         timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Joins the process group the launch describes and returns this
    rank's device; call it first in an entry point. ``launch`` (a dict as
    :func:`launch_env` gives) overrides the environment; None from both is
    a plain process: ``device`` is returned and no group is made.

    ``device``: ``cuda`` is ``cuda:{LOCAL_RANK}``, made the current device
    (a local rank at or past ``torch.cuda.device_count()`` raises); an
    explicit ``cuda:N`` is taken as given (several ranks on one card, with
    ``backend="gloo"``: NCCL refuses that); ``cpu`` runs gloo on the CPU.
    ``backend`` defaults to ``nccl`` on CUDA and ``gloo`` on the CPU;
    ``init_method`` to ``tcp://MASTER_ADDR:MASTER_PORT``."""
    launch = launch_env() if launch is None else launch
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if launch is None:
        return device
    if active():
        raise RuntimeError("the process group is already initialised")
    if device.type == "cuda":
        if device.index is None:
            count = torch.cuda.device_count()
            if launch["local_rank"] >= count:
                raise RuntimeError(f"local rank {launch['local_rank']} has no card: this host "
                                   f"has {count}")
            device = torch.device("cuda", launch["local_rank"])
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=init_method or f"tcp://{launch['addr']}:{launch['port']}",
        world_size=launch["world"], rank=launch["rank"],
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


@contextlib.contextmanager
def process_group(device="cuda", **kwargs):
    """An entry point's group: :func:`init` on entry and :func:`shutdown`
    on exit, or, where the caller has joined a group already (a test or a
    script that spawns its ranks), that group and this rank's device.
    Yields the device."""
    if active():
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        yield device
        return
    device = init(device, **kwargs)
    try:
        yield device
    finally:
        shutdown()


def shutdown() -> None:
    """Leaves the process group (nothing without one)."""
    if active():
        dist.destroy_process_group()


def active() -> bool:
    """Whether this process is in a group (of one or more ranks)."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if active():
        dist.barrier()


class _GlobalSum(torch.autograd.Function):
    """All-reduce (sum) whose backward sums the cotangents over the ranks:
    rank s's input reaches every rank's output, so its gradient is the sum
    of what every rank's loss sends back."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable; ``x`` itself without a
    group."""
    return _GlobalSum.apply(x) if active() else x


def global_moments(x: torch.Tensor, valid=None):
    """The mean and biased variance of each channel (dim 1) of ``x`` over
    its other dims and over the ranks, and the count they divide by (at
    least 1): the sums and the count are summed over the ranks, then the
    centred square sums (two passes, which float32 needs). ``valid`` masks
    the rows (dim 0); rows it leaves out count nowhere. Differentiable
    through both sums; one process's moments without a group."""
    dims = (0,) + tuple(range(2, x.dim()))
    if valid is None:
        w, count = None, x.new_full((1,), float(x.numel() // x.shape[1]))
    else:
        w = valid.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
        count = w.sum().reshape(1) * float(math.prod(x.shape[2:]))
    sums = global_sum(torch.cat([(x if w is None else x * w).sum(dim=dims), count]))
    count = torch.clamp(sums[-1], min=1.0)
    mean = sums[:-1] / count
    dev = torch.square(x - mean.reshape((1, -1) + (1,) * (x.dim() - 2)))
    var = global_sum((dev if w is None else dev * w).sum(dim=dims)) / count
    return mean, var, count


def all_sum_flat(tensors, marks=None) -> list:
    """The tensors summed over the ranks by one all-reduce of a flat
    buffer in their common dtype, returned as views of it in their shapes
    (the inputs themselves without a group). Carries no gradient.
    ``marks``: three CUDA events, recorded before the packing, between it
    and the all-reduce, and after."""
    if not active():
        return list(tensors)
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    if marks:
        marks[0].record()
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    if marks:
        marks[1].record()
    dist.all_reduce(flat)
    if marks:
        marks[2].record()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at: at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def global_count(x: torch.Tensor) -> torch.Tensor:
    """A count summed over the ranks, without a gradient: a loss's
    denominator."""
    x = x.detach()
    if not active():
        return x
    y = x.clone()
    dist.all_reduce(y)
    return y


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean over the global batch of ``x``'s
    elements: its sum over the count of every rank's elements (``x.mean()``
    without a group)."""
    if not active():
        return x.mean()
    return x.sum() / global_count(x.new_full((), float(x.numel())))


def local_rows(batch_size: int) -> int:
    """The rows of a global batch of ``batch_size`` this rank holds; raises
    where the world does not divide it, as the JAX sharding does."""
    w = world()
    if batch_size % w:
        raise ValueError(f"TRAIN.BATCH_SIZE {batch_size} is not divisible by the {w} ranks")
    return batch_size // w


def shard_rows(batch):
    """This rank's contiguous rows ``[r B / W, (r + 1) B / W)`` of every
    array in a batch (dict, list, numpy array or tensor with the batch
    first), as ``P("data")`` places them on device r."""
    if isinstance(batch, dict):
        return {k: shard_rows(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_rows(v) for v in batch)
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        n = local_rows(batch.shape[0])
        return batch[rank() * n: (rank() + 1) * n]
    return batch


@torch.no_grad()
def broadcast_state(module: torch.nn.Module) -> None:
    """Every parameter and buffer of ``module`` from rank 0, so that the
    ranks start from the same state whatever each loaded or drew."""
    if not active():
        return
    for t in module.state_dict().values():
        dist.broadcast(t, src=0)


def _rank_main(payload, rank_, world_, store, out_path, device, backend, timeout_s):
    torch.set_num_threads(1)
    fn, args = torch.load(payload, weights_only=False)
    init(device, launch={"launcher": "spawn", "rank": rank_, "world": world_,
                         "local_rank": rank_}, backend=backend, init_method=store,
         timeout_s=timeout_s)
    try:
        torch.save(fn(*args), out_path)
    finally:
        shutdown()


def run_ranks(fn, world_: int, workdir, *args, device="cpu", backend=None,
              deadline_s: float = 60.0) -> list:
    """Runs ``fn(*args)`` in ``world_`` fresh processes (the ``spawn``
    start method), each a rank of one group that meets through a file
    store in ``workdir`` (TCP ports would collide between concurrent
    runs); returns each rank's result (``torch.save``-able), in rank
    order. ``fn`` is a module-level function; the arguments reach the
    ranks through a file in ``workdir``; each process runs torch on one
    thread. ``device``: ``cpu`` (gloo), or an explicit ``cuda:N`` shared by
    every rank with ``backend="gloo"``. The ranks must end within
    ``deadline_s``: past it they are killed and TimeoutError is raised
    (their collectives time out at the same deadline); a rank that fails
    raises RuntimeError."""
    ctx = multiprocessing.get_context("spawn")
    os.makedirs(workdir, exist_ok=True)
    tag = time.time_ns()
    payload = os.path.join(workdir, f"payload.{tag}.pt")
    torch.save((fn, args), payload)
    store = f"file://{os.path.abspath(os.path.join(workdir, f'store.{tag}'))}"
    outs = [os.path.join(workdir, f"rank{r}.{tag}.pt") for r in range(world_)]
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(payload, r, world_, store, outs[r], device, backend, deadline_s))
             for r in range(world_)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    if hung:
        raise TimeoutError(f"ranks {hung} of {world_} did not end within {deadline_s} s")
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if failed:
        raise RuntimeError(f"ranks failed (rank: exit code) {failed}")
    return [torch.load(path, weights_only=False) for path in outs]
