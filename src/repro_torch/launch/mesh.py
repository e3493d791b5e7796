"""Meshes (port of ``repro/launch/mesh.py``) over
``torch.distributed.device_mesh``, and a local launcher of ranks.

A mesh is a ``DeviceMesh`` with the reference's axis names: ("data",
"model") on a host or a pod, ("pod", "data", "model") across pods.  Both
constructors need a process group of the mesh's size: the caller starts
it (``torch.distributed.init_process_group`` with an address, world size
and rank of its own: nothing in the environment names a cluster), or
:func:`run_ranks` starts one for each rank it spawns.  The production
meshes can be built on a fake process group (backend ``"fake"`` over
``torch.testing._internal.distributed.fake_pg.FakeStore``), which
allocates nothing: what a dry-run needs.

Functions, not module constants, so importing this module touches no
device or process group.  DTensor API relied on (torch 2.11 and 2.13):
``torch.distributed.device_mesh.init_device_mesh``.
"""

from __future__ import annotations

import os
import socket
import tempfile

import torch

from repro_torch.device import resolve_device

__all__ = ["make_production_mesh", "make_host_mesh", "run_ranks"]


def _need_world(want: int, what: str) -> None:
    import torch.distributed as dist

    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != want:
        raise ValueError(
            f"{what} needs a process group of {want} ranks; the world size "
            f"is {have}" + ("" if have else " (no process group)"))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 = 256 ranks a pod ("data", "model"); 2 pods = 512 ranks
    ("pod", "data", "model").  Raises ``ValueError`` naming the world size
    when the process group does not have 256 (512) ranks.  ``device``
    names the mesh's device type; a fake process group takes any."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _need_world(int(torch.tensor(shape).prod()),
                f"the {'multi-pod ' if multi_pod else ''}production mesh")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, *, device="cuda"):
    """A (data, model) mesh over the process group's ranks, on ``device``
    (``"cuda"`` by default, which raises without a card; pass
    ``device="cpu"`` for gloo ranks on the CPU).  The process group must
    have ``data * model`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    _need_world(data * model, f"a ({data}, {model}) host mesh")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


def _free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, backend, init, out_dir, args):
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    try:
        res = fn(rank, world, *args)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, *args, backend: str = "gloo") -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes that share one process group (``backend``, over
    ``tcp://localhost:<free port>``); returns each rank's result (what
    ``torch.save`` can write), in rank order.  ``fn`` must be importable
    by name.  A rank that raises makes this raise."""
    import torch.multiprocessing as mp

    init = f"tcp://localhost:{_free_port()}"
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(
            _rank_main, args=(fn, world_size, backend, init, out_dir, args),
            nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
