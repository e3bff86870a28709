"""Worker meshes of the port's sharded driver (``core/sharded.py``).

The reference builds a ``jax`` device mesh; the port runs one process a
rank under ``torch.distributed``, so its mesh is a small description: the
world size, the backend the ranks' tensor collectives run over, and each
rank's device. The backend rule is fixed, not a fallback:

* a graph on the CPU puts every rank on the CPU, over ``gloo``;
* a graph on CUDA puts rank w on ``cuda:(w % cards)``, over ``nccl``
  when every rank has a card of its own, else over ``gloo`` (NCCL
  refuses two ranks on one GPU). gloo's all-to-all takes CUDA tensors and
  stages them through the host itself.

The production mesh is the reference's (16, 16) or (2, 16, 16) pod
mesh: one rank a device, 256 or 512 of them. It is a description too: a
real run needs a ``torch.distributed`` world of exactly that many ranks
(``require_world``), and the dry runs (``launch/pregel_run.py
--dryrun``, ``launch/dryrun.py``) stand rank 0 of it up over a fake
group (``fake_group``). Over such a group (or a real world of its size)
``ProductionMesh.device_mesh`` builds the ``torch.distributed``
``DeviceMesh`` the LLM dry run places its DTensors on; ``device_mesh``
builds any other (the tests' (2, 2) and (2, 1, 2) meshes).

Nothing here touches a device at import time.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Tuple

# ranks that may share one card over gloo: each holds its own CUDA
# context and caching allocator on that card
MAX_RANKS_PER_CARD = 8


@dataclass(frozen=True)
class HostMesh:
    """A 1-D ("data",) mesh of ``n_workers`` ranks on one host."""
    n_workers: int
    backend: str                  # "nccl" | "gloo"
    devices: Tuple[str, ...]      # rank w's device
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def shape(self) -> dict:
        return {"data": self.n_workers}


def backend_for(n_workers: int, device_type: str) -> str:
    """The transport rule: NCCL when every rank has a card of its own,
    gloo otherwise (and always on the CPU)."""
    if device_type != "cuda":
        return "gloo"
    import torch
    return "nccl" if n_workers <= torch.cuda.device_count() else "gloo"


def make_host_mesh(devices: Optional[int] = None, *,
                   device="cuda") -> HostMesh:
    """A 1-D mesh of ``devices`` ranks (None: one a card on CUDA, one on
    the CPU) for a graph on ``device``. Raises when more ranks are asked
    for than the transport can place: on CUDA, more than
    ``MAX_RANKS_PER_CARD`` ranks a card (or no card at all); on the CPU,
    more ranks than the host has cores."""
    import torch
    kind = torch.device(device).type
    if kind == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("a CUDA mesh needs a card: no CUDA device "
                               "present (load the graph on the CPU)")
        n = cards if devices is None else int(devices)
        if n > cards * MAX_RANKS_PER_CARD:
            raise RuntimeError(
                f"requested a {n}-rank mesh but {cards} card(s) hold at "
                f"most {cards * MAX_RANKS_PER_CARD} ranks "
                f"({MAX_RANKS_PER_CARD} a card)")
        devs = tuple(f"cuda:{w % cards}" for w in range(n))
    elif kind == "cpu":
        n = 1 if devices is None else int(devices)
        cores = os.cpu_count() or 1
        if n > cores:
            raise RuntimeError(f"requested a {n}-rank CPU mesh but the "
                               f"host has {cores} core(s)")
        devs = ("cpu",) * n
    else:
        raise ValueError(f"no mesh for device {device}")
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    return HostMesh(n_workers=n, backend=backend_for(n, kind),
                    devices=devs)


@dataclass(frozen=True)
class ProductionMesh:
    """The pod mesh: ``shape`` over ``axis_names``, one rank a device;
    the partition axis shards over all of them."""
    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def n_ranks(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def device_mesh(self):
        """This mesh as a ``DeviceMesh`` over the default process group
        (which must have ``n_ranks`` ranks: a real world, or
        ``fake_group``)."""
        return device_mesh(self.dims, self.axis_names)


def device_mesh(dims, axis_names):
    """A CPU ``DeviceMesh`` of ``dims`` named ``axis_names`` over the
    default process group, which must have prod(dims) ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(dims),
                            mesh_dim_names=tuple(axis_names))


@contextmanager
def fake_group(world: int):
    """A default process group of ``world`` ranks with this process as
    rank 0, over c10d's ``fake`` backend: its collectives move nothing
    and accept meta tensors. Destroyed on exit; refused when a default
    group already exists (the dry run would replace it)."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("the dry run stands up its own fake process "
                           "group: a default group already exists")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """The reference's (16, 16) ("data", "model") mesh of 256 ranks, or
    its (2, 16, 16) ("pod", "data", "model") mesh of 512."""
    if multi_pod:
        return ProductionMesh((2, 16, 16), ("pod", "data", "model"))
    return ProductionMesh((16, 16), ("data", "model"))


def require_world(mesh: ProductionMesh) -> int:
    """A real run on the production mesh runs in place, as one rank of
    an initialized ``torch.distributed`` world of exactly
    ``mesh.n_ranks`` ranks (for example under ``torchrun``). -> this
    process's rank; raises ``RuntimeError`` otherwise."""
    import torch.distributed as dist
    n = mesh.n_ranks
    have = (dist.get_world_size() if dist.is_available()
            and dist.is_initialized() else 0)
    if have != n:
        raise RuntimeError(
            f"the {mesh.dims} production mesh runs as one rank of a "
            f"{n}-rank torch.distributed world (start {n} ranks, e.g. "
            f"with torchrun, and initialize the process group); this "
            f"process has " + (f"a {have}-rank world" if have
                               else "no process group"))
    return dist.get_rank()


def axis_names(mesh) -> tuple:
    """The axis names of a mesh: a description's, or a ``DeviceMesh``'s
    dimension names."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    if hasattr(mesh, "mesh_dim_names"):
        return mesh.size(axis_names(mesh).index(name))
    return mesh.shape[name]


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (('pod','data') when multi-pod)."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def batch_axis_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= axis_size(mesh, a)
    return n
