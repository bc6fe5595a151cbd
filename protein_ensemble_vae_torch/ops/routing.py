"""Single kernel-routing policy (counterpart of the JAX package's
``ops/routing.py``).

``ModelConfig.use_pallas_egnn`` keeps its name and its values, since it is
part of the checkpoint sidecar; here it chooses between a hand-written CUDA
kernel and its plain PyTorch version over the same parameters:

- ``"auto"`` or ``"interpret"``: the kernel for a CUDA tensor, the plain
  version for a CPU tensor (a CUDA kernel has no interpret mode);
- ``True``: the kernel; raises for a CPU tensor, as the JAX side raises
  off-TPU rather than run a slow stand-in;
- ``False`` / ``None``: the plain version everywhere.
"""

from __future__ import annotations

import torch


def set_full_fp32() -> None:
    """Turn TF32 off for PyTorch's matrix products and convolutions
    (``torch.matmul`` and cuDNN then run in full fp32). The port's
    hand-written EGNN band kernels reach fp32 accuracy another way: their
    products run on the tensor cores in 3-pass TF32, as the JAX side's
    ``Precision.HIGHEST`` does through multi-pass products on the TPU.
    Generation and training set this on entry, for fp32 and bf16 models
    alike: the fp32 heads (``l2c_out``, ``seq_out``, ``n_off2``,
    ``c_off2``) and every other fp32 product stay in full fp32. Only the
    band kernels' products drop to one TF32 pass, and only in their
    bf16-model mode (``precision="default"``, the JAX side's ``None``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(name: str) -> torch.device:
    """The requested device; a CUDA device without a GPU raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r}: no CUDA device is available. "
                           "Pass the device \"cpu\" (--device cpu on a "
                           "command line) to run on the CPU.")
    return device


def pallas_policy(t: torch.Tensor, use_pallas: object = "auto") -> bool:
    """Decide whether the hand-written kernel runs on tensor ``t``."""
    on_cuda = t.is_cuda
    if use_pallas in ("auto", "interpret"):
        return on_cuda
    if use_pallas:
        if not on_cuda:
            raise RuntimeError(
                "use_pallas_egnn=True forces the CUDA kernel, but the tensor "
                f"lies on {t.device}. Use \"auto\" (the plain version off the "
                "GPU) or False.")
        return True
    return False
