"""Device meshes of the port's sharded runtimes, on ``torch.distributed``.

The port of ``repro/launch/mesh.py``'s PS meshes: ``make_ps_mesh`` (dims
``("data", "model")``) and ``make_pods_mesh`` (``("pod", "data",
"model")``), each a ``DeviceMesh`` over the whole world, one process per
mesh point.  The JAX package builds its meshes over the devices one
process sees; here every rank is a process with one device, so a mesh's
size is the world's.  The production and dry-run meshes of the TPU pods
and their roofline constants have no counterpart.

Backends follow the device and never fall back: the card takes NCCL
(``cuda:<local rank>``), the CPU gloo.  ``ensure_world`` makes a world of
one rank when no process group exists (the card runs the runtime so);
worlds of more ranks are started by the caller (``launch.worlds`` for the
CPU tests).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def process_device(device=None) -> torch.device:
    """This rank's device: ``cuda:<local rank>`` by default (``LOCAL_RANK``,
    else the rank modulo the card count), or ``device`` as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
    return dev


def ensure_world(device: torch.device) -> None:
    """Make a world of one rank on ``device``'s backend when no process
    group exists; check that an existing one has that backend."""
    backend = _BACKEND.get(device.type)
    if backend is None:
        raise ValueError(f"no process-group backend for device {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    have = dist.get_backend()
    if have != backend:
        raise RuntimeError(f"the process group runs {have!r}; the runtime "
                           f"on {device.type} needs {backend!r} (it never "
                           f"falls back to another backend or device)")


def _mesh(device, shape, names) -> DeviceMesh:
    device = process_device(device)
    ensure_world(device)
    n = dist.get_world_size()
    size = 1
    for s in shape:
        size *= s
    if size != n:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} "
                         f"{tuple(names)} needs {size} ranks; the world has "
                         f"{n} (one process per mesh point)")
    return init_device_mesh(device.type, tuple(shape), mesh_dim_names=names)


def make_ps_mesh(data: int | None = None, model: int | None = None,
                 device=None) -> DeviceMesh:
    """``("data","model")`` mesh for the executable parameter server: "data"
    carries the PS workers, "model" the parameter shards.  The JAX
    package's policy: ``model = 2`` when the world is even and larger than
    one, the rest data."""
    ensure_world(process_device(device))
    n = dist.get_world_size()
    if model is None:
        if data is not None:
            if n % data:
                raise ValueError(f"data={data} does not divide the {n} "
                                 f"ranks; pass model= explicitly")
            model = n // data
        else:
            model = 2 if (n > 1 and n % 2 == 0) else 1
    if data is None:
        if n % model:
            raise ValueError(f"model={model} does not divide the {n} ranks; "
                             f"pass data= explicitly")
        data = n // model
    return _mesh(device, (data, model), ("data", "model"))


def make_pods_mesh(pods: int | None = None, data: int | None = None,
                   model: int | None = None, device=None) -> DeviceMesh:
    """3-D ``("pod","data","model")`` mesh for the hierarchical runtime:
    "pod" carries the parameter-shard replicas, "data" a pod's workers,
    "model" its shards.  The JAX package's defaults: 2 pods when the world
    allows (even and >= 4), then ``make_ps_mesh``'s policy within a pod."""
    ensure_world(process_device(device))
    n = dist.get_world_size()
    if pods is None:
        pods = 2 if n % 2 == 0 and n >= 4 else 1
    if n % pods:
        raise ValueError(f"pods={pods} does not divide the {n} ranks")
    per_pod = n // pods
    if model is None:
        if data is not None:
            if per_pod % data:
                raise ValueError(
                    f"data={data} does not divide the per-pod rank count "
                    f"({per_pod}); pass model= explicitly")
            model = per_pod // data
        else:
            model = 2 if (per_pod > 1 and per_pod % 2 == 0) else 1
    if data is None:
        if per_pod % model:
            raise ValueError(
                f"model={model} does not divide the per-pod rank count "
                f"({per_pod}); pass data= explicitly")
        data = per_pod // model
    return _mesh(device, (pods, data, model), ("pod", "data", "model"))
