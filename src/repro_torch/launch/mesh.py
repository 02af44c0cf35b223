"""Production meshes (twin of ``repro/launch/mesh.py``) and the H100's
roofline constants.

The production meshes keep the reference's shapes and axis names, a pod of
16 x 16 = 256 devices ('data', 'model') and two pods, 2 x 16 x 16 = 512
('pod', 'data', 'model'), so the sharding rules see the same axis sizes
cell for cell.  They are sizing meshes: one process holds rank 0 of a
``torch.distributed`` group on the "fake" backend (every collective
returns at once, nothing is sent), which is all a trace on fake tensors
needs.  ``make_host_mesh`` builds a mesh over a real group (gloo on the
CPU, nccl on cards) that the caller has initialised.

``make_run_mesh`` is the training driver's production mesh: the same
shapes and names over the real group that ``torchrun`` starts (NCCL, one
rank a GPU).

All constructors are functions: importing this module touches no process
group.  A sizing mesh's group is torn down by ``destroy_sizing_mesh``.
"""
from __future__ import annotations

import os

POD_SHAPE = {"data": 16, "model": 16}
MULTIPOD_SHAPE = {"pod": 2, "data": 16, "model": 16}

# NVIDIA H100 80GB HBM3 (SXM) from its data sheet, the card of
# ``chip_smoke.py`` (nvidia-smi: "NVIDIA H100 80GB HBM3, 700.00 W"): dense
# bf16 tensor-core peak, HBM3 bandwidth, NVLink 4 per direction (900 GB/s
# bidirectional) and device memory.
HW_H100 = {
    "name": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "peak_flops_bf16": 989e12,      # per card
    "hbm_bw": 3.35e12,              # bytes/s per card
    "ici_bw": 450e9,                # bytes/s per direction (NVLink)
    "hbm_bytes": 80e9,              # device memory per card
}


def production_shape(multi_pod: bool = False) -> dict:
    return dict(MULTIPOD_SHAPE if multi_pod else POD_SHAPE)


def make_sizing_mesh(shape: dict, rank: int = 0, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` ({axis: size}, in mesh order) on a
    fake process group of prod(sizes) ranks, this process rank ``rank``,
    its tensors on ``device_type`` (a rank's local shards on a card:
    "cuda").  An existing group of another size or rank is torn down
    first."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = n_devices(shape)
    if dist.is_initialized():
        if (dist.get_backend() == "fake" and dist.get_world_size() == n
                and dist.get_rank() == rank):
            return init_device_mesh(device_type, tuple(shape.values()),
                                    mesh_dim_names=tuple(shape))
        destroy_sizing_mesh()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def destroy_sizing_mesh() -> None:
    """Tear down the fake process group a sizing mesh made (no-op when none
    is up; a real group is left alone)."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh as a sizing mesh: (16, 16) 'data',
    'model', or (2, 16, 16) 'pod', 'data', 'model'."""
    return make_sizing_mesh(production_shape(multi_pod))


def make_host_mesh(data: int = 1, model: int = 1):
    """A ('data', 'model') mesh over the ranks of the process group the
    caller initialised (tests: gloo; cards: nccl); data * model must equal
    its world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    assert data * model == n, (data, model, n)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (data, model),
                            mesh_dim_names=("data", "model"))


def init_group_from_env() -> None:
    """The process group of ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``):
    NCCL, this rank on GPU ``LOCAL_RANK``."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl")


def make_run_mesh(*, multi_pod: bool = False):
    """The production mesh ((16, 16) 'data', 'model', or (2, 16, 16)
    'pod', 'data', 'model') over the real process group: the one already
    up, else the one ``torchrun``'s environment describes.  Raises
    ``ValueError`` when no group is up or its world size is not the
    mesh's (256 for a pod, 512 for two)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = production_shape(multi_pod)
    n = n_devices(shape)
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        init_group_from_env()
    sizes = (f"{n_devices(POD_SHAPE)} ranks for a pod, "
             f"{n_devices(MULTIPOD_SHAPE)} for two pods")
    if not dist.is_initialized() or dist.get_backend() == "fake":
        raise ValueError(f"the {mesh_label(shape)} mesh trains over a "
                         f"process group of {sizes} (torchrun, one rank "
                         f"a GPU); none is up")
    if dist.get_world_size() != n:
        raise ValueError(f"the {mesh_label(shape)} mesh needs {n} ranks "
                         f"({sizes}); the process group has "
                         f"{dist.get_world_size()}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def mesh_label(shape: dict) -> str:
    return "x".join(str(s) for s in shape.values())


def n_devices(shape: dict) -> int:
    n = 1
    for s in shape.values():
        n *= int(s)
    return n

