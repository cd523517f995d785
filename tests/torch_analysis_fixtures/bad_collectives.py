"""Fixture: mesh dimension hygiene + the masked-before-gather churn rule."""
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def body(u, x, u_all):
    live_now, died = churn_live(schedule, c)  # noqa: F821 (fixture shape)
    total = dist.all_reduce(x, group=mesh.get_group("rows"))  # VIOLATION: axis-unbound
    dist.all_gather_into_tensor(u_all, u, group=mesh.get_group("data"))  # VIOLATION: unmasked-gather
    return total, u_all


mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def stray(x):
    return dist.all_reduce(x, group=mesh.get_group("model"))  # any process may
