"""The production meshes, on a fake 512-rank process group, and the
host mesh a training run shards over.

The counterpart of the reference's ``launch/mesh.py``, which builds its
meshes over 512 placeholder host devices.  Here the placeholders are the
ranks of torch's ``fake`` process group: every collective on it returns at
once and moves nothing, so a step traced over a `DeviceMesh` of these ranks
on ``meta`` tensors plans the production layout (sharding propagation,
the collectives DTensor inserts, each device's shard shapes) without a
card or a byte of memory.  This process is rank 0, and every mesh is the
block of ranks ``0 .. prod(shape) - 1``, so it holds rank 0.

The group is set up lazily, once per process, at world size 512.  A
default process group that already exists with another backend (a real
training run) is an error, not something to reuse.

Production target of the reference: TPU v5e, 256 chips/pod (16x16), two
pods = 512 chips for the multi-pod dry-run.

`make_host_mesh` is the other kind: a ``(data, model)`` mesh over the real
ranks of the default process group (one process a device, as ``torchrun``
starts them), on which `launch.train` trains.  It never touches the fake
group.
"""

from __future__ import annotations

import contextlib
import math
import os

from ..models.config import ParallelConfig
from ..parallel.sharding import POD_DATA

#: ranks of the fake group (the reference's placeholder device count)
WORLD_SIZE = 512

#: DeviceMesh device type: the collectives DTensor emits for an
#: accelerator mesh (``cpu`` would select gloo's fallbacks, e.g. an
#: all-to-all lowered as an all-gather); the stand-ins stay on ``meta``
MESH_DEVICE_TYPE = "cuda"


def fake_world() -> None:
    """Initialise the fake process group (world 512, this process rank 0)
    unless it is up already."""
    import torch.distributed as dist

    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != "fake":
            raise RuntimeError(
                f"a default process group with backend {backend!r} exists; the dry-run "
                "meshes need the fake backend in a process of their own")
        if dist.get_world_size() != WORLD_SIZE:
            raise RuntimeError(
                f"the fake process group has world size {dist.get_world_size()}, "
                f"not {WORLD_SIZE}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=WORLD_SIZE)


def destroy_fake_world() -> None:
    """Tear the fake group down (a no-op if none is up)."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def make_mesh(shape: tuple, axes: tuple):
    """A `DeviceMesh` of ``shape`` named ``axes`` over ranks ``0 ..
    prod(shape) - 1`` of the fake group."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if len(shape) != len(axes) or n > WORLD_SIZE:
        raise ValueError(f"mesh {shape} over axes {axes} does not fit {WORLD_SIZE} ranks")
    fake_world()
    mesh = DeviceMesh(MESH_DEVICE_TYPE, torch.arange(n).reshape(shape), mesh_dim_names=axes)
    if "pod" in axes:  # the DTensors' 2-D view, `parallel.sharding.compute_mesh`
        mesh["pod", "data"]._flatten(POD_DATA)
    return mesh


def make_production_mesh(*, multi_pod: bool = False, mesh_shape: tuple | None = None):
    """16x16 ``(data, model)``, or 2x16x16 ``(pod, data, model)`` with
    ``multi_pod``; an explicit ``mesh_shape`` is built the same way."""
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if len(mesh_shape) == 3 else ("data", "model")
    return make_mesh(tuple(mesh_shape), axes)


def parallel_config_for(mesh) -> ParallelConfig:
    data_axes = ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
    return ParallelConfig(data_axes=data_axes)


def make_host_mesh(model: int = 1, device: "str | None" = None):
    """A ``(data, model)`` `DeviceMesh` over the ranks of the default
    process group, ``data = world // model``, rank ``r`` at ``divmod(r,
    model)``.  Its device type is ``device``'s (``cuda``, the default, one
    card a rank: ``cuda:LOCAL_RANK``; ``cpu`` over gloo).  Without a group
    (the fake one does not count) the world is this one process: raises
    `ValueError` where ``model`` does not divide the world size, then
    `RuntimeError` where no group is up."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ..device import resolve_device

    dev = resolve_device(device)
    up = host_group_up()
    world = dist.get_world_size() if up else 1
    if model < 1 or world % model:
        raise ValueError(
            f"--model-parallel {model} does not divide the world size {world}: start one "
            f"process a device with `torchrun --nproc-per-node N` for an N that {model} "
            "divides")
    if not up:
        raise RuntimeError("make_host_mesh needs a default process group of real ranks "
                           "(torchrun, or torch.distributed.init_process_group)")
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank())
    ranks = torch.arange(world).reshape(world // model, model)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=("data", "model"))


def host_group_up() -> bool:
    """Whether a default process group of real ranks is up (the dry-run's
    fake group is not one)."""
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_backend() != "fake"


def local_rank() -> int:
    """This process's device index on its host: torchrun's ``LOCAL_RANK``,
    else the global rank modulo the host's cards."""
    import torch
    import torch.distributed as dist

    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = dist.get_rank() if dist.is_initialized() else 0
    return rank % max(1, torch.cuda.device_count())


@contextlib.contextmanager
def torchrun_group(device: "str | None" = None):
    """Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` in the environment)
    with no default group up: initialise one for the run -- NCCL on
    ``cuda:LOCAL_RANK``, gloo for ``device="cpu"`` -- from torchrun's
    rendezvous variables, and destroy it on the way out.  Otherwise a
    no-op."""
    import torch
    import torch.distributed as dist

    from ..device import resolve_device

    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ or dist.is_initialized():
        yield
        return
    if resolve_device(device).type == "cuda":
        dist.init_process_group("nccl", device_id=torch.device("cuda", local_rank()))
    else:
        dist.init_process_group("gloo")
    try:
        yield
    finally:
        dist.destroy_process_group()
