"""The SRDS device mesh and the process groups under it (counterpart of
``repro.launch.mesh``).

A JAX mesh is a view of the devices one program sees; a torch mesh is a
``DeviceMesh`` over the ranks of a process group, one process per card
(NCCL) or per CPU worker (gloo).  Every rank builds the same mesh, after
:func:`init_process_group` has started the default group.  Nothing here
tells a process of a cluster: the caller gives the store's directory, the
rank and the world size (:func:`spawn_ranks` does so for N local ranks).

    from repro_torch.launch.mesh import spawn_ranks, make_srds_mesh

    def work(rank, world_size):
        mesh = make_srds_mesh(world_size, device_type="cpu")
        ...                       # make_sharded_sampler(mesh, "time", ...)

    results = spawn_ranks(work, 4, device_type="cpu")   # gloo, 4 ranks

The TPU roofline constants of the JAX module are not ported; the
production pod meshes wait for ROADMAP A10(c).
"""
from __future__ import annotations

import os
import pickle
import tempfile
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

from repro_torch.parallel.collectives import BACKENDS

__all__ = ["init_process_group", "make_srds_mesh", "make_test_mesh",
           "spawn_ranks"]


def init_process_group(store_dir: str, rank: int, world_size: int, *,
                       device_type: str = "cuda",
                       local_rank: int = None) -> str:
    """Start the default process group from a ``file://`` store in
    ``store_dir`` (a directory every rank sees; the caller removes it):
    NCCL for ``device_type="cuda"``, after ``torch.cuda.set_device(
    local_rank)`` (default: ``rank``), gloo for ``"cpu"``.  Returns the
    backend."""
    backend = BACKENDS[device_type]
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass "
                               "device_type='cpu' for a gloo group")
        torch.cuda.set_device(rank if local_rank is None else local_rank)
    store = os.path.join(os.path.abspath(store_dir), "store")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world_size)
    return backend


def make_srds_mesh(time: int, data: int = 1, model: int = 1, *,
                   device_type: str = "cuda"):
    """The SRDS ``(time, data, model)`` mesh: Parareal blocks over
    ``time``, independent sample lanes over ``data``, the denoiser's own
    parallelism over ``model``.  Dims of size 1 are kept, so one
    driver covers every composition; needs ``time * data * model`` ranks
    in the default group.  Rank ``r`` sits at ``(r // (data * model),
    (r // model) % data, r % model)``, row-major as JAX's mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (time, data, model),
                            mesh_dim_names=("time", "data", "model"))


def make_test_mesh(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = ("data", "model"), *,
                   device_type: str = "cuda"):
    """A small mesh of named dims over the default group (the tests use
    ``device_type="cpu"`` on a gloo group)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def _rank_main(rank: int, fn: Callable, world_size: int, args: tuple,
               store_dir: str, device_type: str) -> None:
    if device_type == "cpu":
        # N ranks share the host's cores
        torch.set_num_threads(1)
    init_process_group(store_dir, rank, world_size, device_type=device_type)
    try:
        out = fn(rank, world_size, *args)
        with open(os.path.join(store_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, *args,
                device_type: str = "cuda") -> List:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new
    processes, each with the default group started
    (:func:`init_process_group` on a ``file://`` store in a temporary
    directory), and return the ranks' return values in rank order.
    ``fn`` must be importable by name (a module-level function) and its
    results picklable.  A rank that raises makes this raise; the others
    are stopped."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as store_dir:
        mp.spawn(_rank_main, args=(fn, world_size, args, store_dir,
                                   device_type),
                 nprocs=world_size, join=True)
        out = []
        for rank in range(world_size):
            with open(os.path.join(store_dir, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
