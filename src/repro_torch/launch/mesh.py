"""Mesh construction for the launchers.

Port of ``repro/launch/mesh.py``: functions, never module-level meshes, so
that importing this module joins no process group.  A mesh is made over
the ranks of the process group (``torchrun``, ``spawn_fake_devices``, or a
world of one); :func:`repro_torch.dist.compat.make_mesh` raises, before
joining anything, when the world does not have the ranks the mesh needs.
"""

from __future__ import annotations

from ..dist.compat import Mesh, make_mesh, world_size


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production meshes: (data 16, model 16), or (pod 2, data 16,
    model 16) with ``multi_pod``; they need 256 and 512 ranks.  The
    three-axis mesh has a joint group over (pod, data), the batch's axes."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device=device,
                         pairs=(("pod", "data"),))
    return make_mesh((16, 16), ("data", "model"), device=device)


def make_host_mesh(model: int = 1, device=None) -> Mesh:
    """A (world // model, model) ("data", "model") mesh over the ranks there
    are; ``ValueError`` when ``model`` does not divide the world."""
    n = world_size()
    if model < 1 or n % model:
        raise ValueError(f"--model-parallel {model} does not divide the world of {n} rank(s): "
                         f"start a multiple of {model} ranks (torchrun --nproc-per-node, or "
                         f"spawn_fake_devices)")
    return make_mesh((n // model, model), ("data", "model"), device=device)
