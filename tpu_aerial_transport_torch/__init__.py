"""tpu-aerial-transport on PyTorch and CUDA: the NVIDIA H100 port.

A second package beside the JAX one (``tpu_aerial_transport``), which stays the
reference every module here is tested against. It imports ``torch`` and
numpy only -- never ``jax``, ``flax`` or anything of the JAX package.

Idiom: plain functions on tensors, small dataclasses and ``NamedTuple``s in
place of the ``flax.struct`` pytrees, explicit leading batch axes
``(S scenarios, n agents, ...)`` instead of ``vmap``, and an explicit
``device`` argument on every entry point that defaults to ``"cuda"``. There is
no probing that carries on on the CPU when no card is found: a caller that
wants the CPU (the tests) passes ``device="cpu"``.

Precision: the compute is dominated by small (3x3 .. 48x48) matrix products in
the rigid-body dynamics and the conic-QP solver, where reduced-precision
mantissas corrupt the physics and the KKT residuals. Matrix products therefore
run in full float32 (TF32 off), as the JAX package pins
``jax_default_matmul_precision=highest``. All state is float32.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

DTYPE = _torch.float32


def resolve_device(device="cuda") -> _torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default) needs a
    visible card and raises without one -- it never falls back to the CPU;
    pass ``device="cpu"`` to run the plain PyTorch path on the host."""
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={device!r}: expected 'cuda' or 'cpu'")
    return dev
