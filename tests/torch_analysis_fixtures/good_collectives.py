"""Fixture: clean collective usage -- no findings."""
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def body(u, x, u_all):
    live_now, died = churn_live(schedule, c)  # noqa: F821 (fixture shape)
    u = torch.where(live_now[:, None], u, 0.0)     # mask BEFORE the gather
    total = dist.all_reduce(x, group=mesh.get_group("model"))
    dist.all_gather_into_tensor(u_all, u, group=mesh.get_group("data"))
    return total, u_all


mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def generic(x, group):
    # a group passed in (the runtime's _Shard.gather idiom): not refutable
    return dist.all_reduce(x, group=group)
