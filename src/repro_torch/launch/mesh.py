"""Process groups and meshes: the bridge from a plan's serializable
:class:`~repro_torch.exec.plan.MeshSpec` to a live
``torch.distributed.device_mesh.DeviceMesh`` (counterpart of
``repro.launch.mesh``).

One rank is one process.  Where the reference places a sharded array on
the devices of one host, the port runs one process per mesh coordinate,
each holding its own shard, and the collectives go through
``torch.distributed``.  The process group's backend follows from where
the ranks live (:func:`backend_for`): ``nccl`` when each rank has a card
of its own, ``gloo`` on the CPU and when ranks share a card (NCCL refuses
two ranks on one device).  Nothing falls back from one to the other: a
backend that fails to start raises.

The dry run (:mod:`repro_torch.launch.dryrun`) acts as rank 0 of a
production mesh it does not have: :func:`join_fake_group` joins torch's
``fake`` process-group backend, whose collectives return at once, and
:func:`leave_fake_group` leaves it.

Importing this module touches no device and no process group.  Where the
reference keeps its TPU v5e constants, the port keeps the H100's.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.exec.plan import MeshSpec


def production_mesh_spec(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's production meshes, as plan-embeddable specs."""
    if multi_pod:
        return MeshSpec(axes=(("pod", 2), ("data", 16), ("model", 16)))
    return MeshSpec(axes=(("data", 16), ("model", 16)))


def backend_for(device: torch.device, world_size: int) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo`` (the
    CPU, or ranks that share a card)."""
    device = torch.device(device)
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_from_env(device: torch.device) -> Optional[str]:
    """Join the process group ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), with the backend :func:`backend_for` picks; returns
    it, or None when the group already exists (a caller that spawned its
    ranks joined it itself) or the environment names no group.  Under
    ``nccl`` each rank takes the card ``LOCAL_RANK``."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    backend = backend_for(device, world)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://")
    return backend


def require_device(name: str, hint: str) -> torch.device:
    """``torch.device(name)``; raises when it names the card and the
    process sees none (``hint`` says what ``--device cpu`` does
    instead)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           f"pass --device cpu to {hint}")
    return device


def rank_device(device: torch.device) -> torch.device:
    """This rank's device: under ``nccl`` its own card, else ``device``
    (gloo ranks on one card share it)."""
    device = torch.device(device)
    if device.type == "cuda" and dist.is_initialized() \
            and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def build_mesh(spec: MeshSpec):
    """Realise a plan's :class:`MeshSpec` over the ranks of the default
    process group (row-major: rank ``r`` sits at the coordinate ``r``
    unravels to in ``spec.shape``).

    Raises with a pointer to ``plan.per_device()`` when the group has
    fewer ranks than the spec asks for (none at all counts as one): a
    logged sharded plan still replays on one device through its
    per-device sub-plan."""
    from torch.distributed.device_mesh import DeviceMesh
    have = dist.get_world_size() if dist.is_initialized() else 1
    n = spec.n_devices
    if have < n:
        raise ValueError(
            f"mesh {spec.describe()} needs {n} devices but the process "
            f"group has {have} ranks; replay the plan's single-device "
            f"projection (plan.per_device()) or start {n} ranks (torchrun "
            f"--nproc-per-node {n})")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = torch.arange(n).reshape(spec.shape)
    return DeviceMesh(device_type, mesh, mesh_dim_names=spec.axis_names)


def join_fake_group(spec: MeshSpec):
    """Join torch's ``fake`` process-group backend as rank 0 of
    ``spec.n_devices`` ranks and return ``build_mesh(spec)``.  One process
    then stands for the whole mesh: every collective returns at once and
    leaves its output as it was, so a step traces with rank 0's shapes and
    no other rank.  Importing ``fake_pg`` is what registers the backend."""
    import torch.testing._internal.distributed.fake_pg as fake_pg
    if dist.is_initialized():
        raise ValueError("a process group already exists; the dry run "
                         "needs a process of its own")
    dist.init_process_group("fake", rank=0, world_size=spec.n_devices,
                            store=fake_pg.FakeStore())
    return build_mesh(spec)


def leave_fake_group() -> None:
    """Destroy the group :func:`join_fake_group` joined (every subgroup
    with it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


# Hardware constants for the roofline analysis: one H100 SXM5 at its 700 W
# limit (NVIDIA's data sheet).  A 16-wide model axis spans two 8-card
# hosts, whose link is the network, not NVLink: there the collective term
# is a lower bound.  The reference's VMEM_BYTES has no counterpart; each
# kernel's shared-memory limit is its module's SMEM_LIMIT (232,448 B).
PEAK_FLOPS_BF16 = 989e12      # per card, dense tensor-core FLOP/s
HBM_BW = 3.35e12              # per card, bytes/s
LINK_BW = 450e9               # NVLink, per card, bytes/s one way
HBM_BYTES = 80e9              # per card, the 80 GB a rank's peak must fit
