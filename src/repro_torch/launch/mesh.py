"""Device meshes and the H100's roofline constants.

The production meshes keep the reference's shapes, ``(16, 16)`` as
``("data", "model")`` and ``(2, 16, 16)`` as ``("pod", "data",
"model")``, so that every cell divides (and pads qwen1.5-32b's heads
40 -> 48) as it does there.  With no process group initialised they sit
on PyTorch's fake group (world 256 or 512, this process rank 0): the
dry run needs no devices.  Everything is a function, so importing this
module touches no process group.
"""
from __future__ import annotations

import math
import socket

import torch

from ..core.kernels import resolve_device

# One NVIDIA H100 SXM (NVIDIA's data sheet; dense rates at the full
# 700 W limit): the roofline denominators of the dry run.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 tensor cores, dense
HBM_BW = 3.35e12                # B/s, HBM3
# B/s a GPU across nodes: one 400 Gb/s NDR InfiniBand port.  A 16-way
# model axis spans two 8-GPU NVLink nodes, so its collectives run at the
# network's rate; NVLINK_BW (NVLink 4, 900 GB/s both ways) is printed
# beside it for the axes that stay inside a node.
LINK_BW = 50e9
NVLINK_BW = 450e9
# torch.cuda.get_device_properties(0).total_memory on an "NVIDIA H100
# 80GB HBM3" at a 700.00 W power limit (chip_smoke.py, phase 19).
HBM_PER_CHIP = 85_017_493_504


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _fake_group(world: int) -> None:
    """Make the default process group PyTorch's fake one of ``world``
    ranks (this process rank 0), replacing a fake group of another
    size; a real group of another size raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} group of {dist.get_world_size()} "
                f"ranks is initialised; the mesh needs {world}")
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())


def make_fake_mesh(shape: tuple[int, ...],
                   axes: tuple[str, ...] = ("data", "model")):
    """A mesh of ``shape`` on the fake group (no devices)."""
    from torch.distributed.device_mesh import init_device_mesh
    _fake_group(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_fake_mesh((16, 16))


def make_local_mesh(data: int = 1, model: int = 1, device=None):
    """A ``(data, model)`` mesh over the initialised group, on ``device``
    (None: CUDA, raising without a card).  With no group and one rank it
    starts a one-process group (NCCL on the card, gloo on the CPU)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized() and data * model == 1:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}", rank=0,
            world_size=1)
    if dev.type == "cuda":
        torch.cuda.set_device(0 if dev.index is None else dev.index)
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))
