"""Hand-written Hopper kernels for the CPADMM, CPISTA, mesh and LM prefill paths.

Each subpackage mirrors ``repro/kernels/<name>``: ``ref.py`` holds the
plain PyTorch version, ``ops.py`` the public wrapper with its integer
``launches`` counter, and the kernel itself is Triton (``kernel.py``) or
CUDA C++ (``repro_torch/csrc/*.cu``, built by :mod:`.build`).  A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches
the kernel or raises — it never falls back.

    spectral_pointwise   Triton   <- repro/kernels/spectral_pointwise
    cpadmm_tail          Triton   <- repro/kernels/cpadmm_tail
    circulant_matvec     CUDA C++ <- repro/kernels/circulant_matvec
    soft_threshold       Triton   <- repro/kernels/soft_threshold
    banded_conv          CUDA C++ <- repro/kernels/banded_conv
    wire_pack            Triton   <- repro/kernels/wire_pack
    flash_attention      CUDA C++ <- repro/kernels/flash_attention (two kernels:
                                     bf16 by wgmma; float32 by 3xTF32 mma.sync
                                     and bf16 at D = 8, 16, 32 by mma.sync)

``floor`` (Triton, and ``csrc/floor.cu``) holds two empty kernels, one by
each route, whose time is the floor under every kernel's; only
``chip_smoke.py`` launches them.

A kernel launch goes around the torch dispatcher, so each wrapper also
reports it (:func:`report_launch`) to the cost walk of
:mod:`repro_torch.launch.cost_walk`, when one is running.

Given ``meta`` tensors (the dry runs of :mod:`repro_torch.launch.dryrun`
and :mod:`repro_torch.launch.cs_dryrun`), a wrapper makes the checks it
makes on the card, reports the launch of the kernel the card would run,
with its bytes and flops, and returns ``meta`` results of the kernel's
shapes and dtypes: shape propagation, the counterpart of a Pallas custom
call in a lowered HLO.  It computes nothing, and it does not count in the
wrapper's ``launches``; no other device reaches it.
"""

# set by repro_torch.launch.cost_walk.walk while it runs, None otherwise
_launch_hook = None


def report_launch(kernel: str, *tensors, flops: float = 0.0) -> None:
    """Tell a running cost walk that ``kernel`` launched once, moved the
    bytes of ``tensors``, its operands and results, each once, and did
    ``flops`` operations (the counts ``chip_smoke.py`` bounds the kernel's
    time with); a no-op otherwise."""
    if _launch_hook is not None:
        _launch_hook(kernel, sum(t.numel() * t.element_size() for t in tensors), float(flops))


def on_meta(*tensors) -> bool:
    """Whether every one of ``tensors`` is a ``meta`` tensor: the wrapper
    then takes its shape-propagation route (see the module docstring)."""
    return all(t.device.type == "meta" for t in tensors)


def require_cuda_operands(kernel: str, operands: dict, dtypes: dict) -> None:
    """Raise ``ValueError`` unless every operand is a contiguous CUDA tensor of
    its dtype (``dtypes[name]``) and all lie on one device — what a kernel
    launch takes; the wrappers check before they launch.  A ``meta`` tensor
    passes where a CUDA one would: it stands for one in a dry run."""
    for name, t in operands.items():
        if t.device.type not in ("cuda", "meta") or t.dtype != dtypes[name] \
                or not t.is_contiguous():
            raise ValueError(
                f"{kernel} kernel takes contiguous {dtypes[name]} CUDA tensors; {name} is "
                f"{t.dtype} on {t.device}{'' if t.is_contiguous() else ', not contiguous'}"
            )
    if len({t.device for t in operands.values()}) != 1:
        raise ValueError(f"{kernel} operands lie on different devices")
