"""Device meshes of the port, the counterpart of `repro.launch.mesh`.

Meshes are `torch.distributed.DeviceMesh`es over an initialized process
group (the caller starts it: `torchrun` and `init_process_group`, or a
test's own ranks); these are functions, so importing the module touches no
device and no process group.

No counterpart: `make_production_mesh` (a 16x16 or 2x16x16 TPU pod) and
`activate` (entering a mesh as JAX's ambient sharding context) raise.  The
port runs on one card, or on the ranks of a process group, one card each;
a `DeviceMesh` is passed to what uses it and has no ambient form.
"""

from __future__ import annotations

from typing import Tuple


def backend_for(device) -> str:
    """The process group's backend for tensors on `device`: NCCL on the
    card, gloo on the CPU.  Neither stands in for the other."""
    import torch
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def _require_group():
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a device mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    return dist


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16x16 single-pod (256 chips) or 2x16x16 multi-pod
    (512 chips) TPU mesh: no counterpart."""
    raise NotImplementedError(
        "make_production_mesh: a 16x16 or 2x16x16 TPU pod has no "
        "counterpart on the card; build a mesh over the process group's "
        "ranks with make_host_mesh or make_mesh")


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda"):
    """A mesh of `shape` named `axes` over the process group's ranks
    (elastic reshapes, tests on small host counts)."""
    from torch.distributed.device_mesh import init_device_mesh
    _require_group()
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """("data", "model") mesh over every rank of the process group (a
    world of one rank: a 1 x 1 mesh)."""
    n = _require_group().get_world_size()
    assert n % model_parallel == 0
    return make_mesh((n // model_parallel, model_parallel),
                     ("data", "model"), device_type)


def activate(mesh):
    """The reference enters `mesh` as JAX's ambient mesh: no
    counterpart."""
    raise NotImplementedError(
        "activate: PyTorch has no ambient mesh; pass the DeviceMesh (or its "
        "process groups) to what uses it")


def describe(mesh) -> str:
    return (f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
            f"({mesh.size()} devices)")
