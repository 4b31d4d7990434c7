"""Production and host meshes, as ``torch.distributed`` DeviceMeshes.

Counterpart of ``repro.launch.mesh``.  Functions, not module-level
constants: importing this module starts no process group and touches no
device.  Single pod: (data=16, model=16) = 256 cards.  Multi-pod: (pod=2,
data=16, model=16) = 512 cards, where the 'pod' axis carries the federated
clients: K FIRM local steps run with no cross-pod traffic and FedAvg is
one all-reduce over 'pod' (``steps.make_federated_round``).

A production mesh needs a default process group of 256 or 512 ranks: on
a cluster the launcher's, and in the dry-run (``launch.dryrun``) torch's
``fake`` backend, which runs no collective and touches no device.

The roofline constants are those of one NVIDIA H100 80GB HBM3 (SXM) at
its 700 W power limit, from NVIDIA's datasheet.  A 256-card mesh spans
nodes of 8 cards, so its 'data' axis crosses the nodes' network, not
NVLink; ``ICI_BW_PER_LINK`` is one NVLink 4 direction all the same, a
single link term as optimistic as the reference's one ICI term.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import device as device_lib

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))

# NVIDIA H100 80GB HBM3 (SXM) at 700 W, datasheet: dense bf16 tensor-core
# FLOP/s, HBM3 bytes/s, NVLink 4 bytes/s in each direction
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
ICI_BW_PER_LINK = 450e9


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices and no process group: what the
    partition rules (``launch.sharding``) read, as JAX's AbstractMesh."""
    shape: tuple
    mesh_dim_names: tuple

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(16, 16) ('data', 'model'), or (2, 16, 16) ('pod', 'data', 'model'),
    over the default process group, which must have 256 or 512 ranks."""
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs a default process "
                           f"group of {AbstractMesh(shape, names).size} "
                           "ranks (the dry-run starts a fake one)")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=names)


def make_host_mesh(device=None) -> DeviceMesh:
    """A (1, 1) ('data', 'model') mesh on ``device`` (``cuda`` unless the
    caller asks for ``cpu``).

    With no default process group, starts a world-1 group from an
    in-process store (``nccl`` on the card, ``gloo`` on the CPU; no
    address, no network).  Raises without a card when ``cuda`` is asked
    for, and never falls back to another backend.
    """
    dev = device_lib.resolve(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1,
                                **({"device_id": torch.device("cuda", 0)}
                                   if dev.type == "cuda" else {}))
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))
