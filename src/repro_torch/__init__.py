"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The port keeps the reference package's module names so each counterpart is
easy to find (``repro_torch.core.circulant`` <-> ``repro.core.circulant``)
and holds its numbers to the reference in ``tests/test_torch_*.py``.  It
imports ``torch`` (and ``triton`` lazily, inside the kernel launchers) and
nothing of JAX or of ``repro``.

Entry points run on the card: a factory or driver given no ``device=``
uses :func:`repro_torch.device.default_device`, which raises when no CUDA
device is present.  Pass ``device="cpu"`` to run on the CPU; the kernel
wrappers then take their plain PyTorch versions.
"""

from .device import default_device  # noqa: F401
