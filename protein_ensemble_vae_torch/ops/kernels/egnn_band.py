"""EGNN band forward: the CUDA kernel ``csrc/egnn_band_fwd.cu``, its wrapper
and its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/egnn_band.py`` forward
(``egnn_band_fused``). Algebra, for receiver i and offset k (j = i+k-W):

    pre[i,k] = a[i] + bs[j] + |x_i - x_j|^2 * w_d
    m  = silu(silu(pre) @ W_e2 + b_e2)
    agg[i]       = sum_k m * valid(i,k)
    raw_delta[i] = sum_k (silu(m @ W_x1 + b_x1) @ w_x2 + b_x2) * valid * rel

valid(i,k) = in-range & k != W & cmask_i & cmask_j; callers apply
deg_inv * 0.2 to raw_delta. Only the forward is here: generation takes no
gradient.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from protein_ensemble_vae_torch.ops.kernels import LAUNCHES
from protein_ensemble_vae_torch.ops.routing import pallas_policy

Tensor = torch.Tensor

KERNEL = "egnn_band_fwd"
SUPPORTED_HIDDEN = (32, 64, 128, 256)
MAX_SMEM_BYTES = 232448   # what one Hopper block may use (227 KB)

_FN = None


def band_indices(L: int, W: int, device=None) -> tuple[Tensor, Tensor]:
    """Static band geometry: neighbor indices [L, K] (clipped) and the
    in-range/non-self mask [L, K], K = 2W+1."""
    offs = torch.arange(2 * W + 1, device=device) - W
    base = torch.arange(L, device=device)[:, None] + offs[None, :]
    idx = base.clamp(0, L - 1)
    in_range = (base >= 0) & (base < L) & (offs != 0)[None, :]
    return idx, in_range


def band_gather(v: Tensor, idx: Tensor) -> Tensor:
    """Gather neighbors along the band: v [B, L, D], idx [L, K] -> [B, L, K, D]."""
    return v[:, idx]


def egnn_band_reference(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2,
                        b_x2, W: int) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version: the band-gather formulation, materialising the
    [B, L, K, Hd] edge tensors. Same arguments and outputs as the kernel."""
    L = a.shape[1]
    idx, in_range = band_indices(L, W, a.device)
    cm = cmask > 0.5
    valid = in_range[None] & cm[:, :, None] & cm[:, idx]
    mask_k = valid.to(a.dtype)[..., None]                    # [B, L, K, 1]
    rel = x[:, :, None, :] - band_gather(x, idx)             # [B, L, K, 3]
    d2 = torch.sum(rel * rel, dim=-1, keepdim=True)
    pre = a[:, :, None, :] + band_gather(bs, idx) + d2 * w_d.reshape(-1)
    m = F.silu(pre)
    m = F.silu(m @ w_e2 + b_e2.reshape(-1))
    agg = torch.sum(m * mask_k, dim=2)
    w = F.silu(m @ w_x1 + b_x1.reshape(-1)) @ w_x2.reshape(-1, 1) + b_x2.reshape(1)
    raw_delta = torch.sum((w * mask_k) * rel, dim=2)
    return agg, raw_delta


def _kernel_fn():
    global _FN
    if _FN is None:
        from protein_ensemble_vae_torch.ops.kernels.build import load_library

        lib = load_library(KERNEL)
        fn = lib.egnn_band_fwd_f32
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.egnn_band_fwd_error_string.argtypes = [ctypes.c_int]
        lib.egnn_band_fwd_error_string.restype = ctypes.c_char_p
        lib.egnn_band_fwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.egnn_band_fwd_smem_bytes.restype = ctypes.c_size_t
        _FN = (fn, lib)
    return _FN


def _check(name: str, t: Tensor, shape: tuple, device) -> None:
    """Raise unless ``t`` is what the kernel reads: fp32, contiguous,
    16-byte aligned, on ``device``, of ``shape`` (a 1-D ``shape`` accepts
    any layout of that many elements, e.g. [1, Hd] or [Hd, 1])."""
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    ok = (t.numel() == shape[0]) if len(shape) == 1 else tuple(t.shape) == shape
    if not ok:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def egnn_band_fwd(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                  W: int) -> tuple[Tensor, Tensor]:
    """The kernel's wrapper. For CPU tensors it is the plain version; for
    CUDA tensors it launches the kernel on the current stream or raises.

    a, bs [B, L, Hd]; x [B, L, 3]; cmask [B, L]; w_d [1, Hd] or [Hd];
    w_e2, w_x1 [Hd, Hd]; b_e2, b_x1 [Hd]; w_x2 [Hd, 1] or [Hd]; b_x2 [1].
    All fp32. Returns (agg [B, L, Hd], raw_delta [B, L, 3]), fp32.
    """
    if not a.is_cuda:
        return egnn_band_reference(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1,
                                   b_x1, w_x2, b_x2, W)
    B, L, Hd = a.shape
    if Hd not in SUPPORTED_HIDDEN:
        raise ValueError(f"hidden width {Hd} not supported by the kernel "
                         f"(one of {SUPPORTED_HIDDEN})")
    if W < 1:
        raise ValueError(f"band half-width W={W} must be >= 1")
    dev = a.device
    for name, t, shape in (
            ("a", a, (B, L, Hd)), ("bs", bs, (B, L, Hd)), ("x", x, (B, L, 3)),
            ("cmask", cmask, (B, L)), ("w_d", w_d, (Hd,)),
            ("w_e2", w_e2, (Hd, Hd)), ("b_e2", b_e2, (Hd,)),
            ("w_x1", w_x1, (Hd, Hd)), ("b_x1", b_x1, (Hd,)),
            ("w_x2", w_x2, (Hd,)), ("b_x2", b_x2, (1,))):
        _check(name, t, shape, dev)
    fn, lib = _kernel_fn()
    smem = lib.egnn_band_fwd_smem_bytes(Hd, W)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"W={W} at Hd={Hd} needs {smem} B of shared memory "
                         f"per block, more than {MAX_SMEM_BYTES}")
    agg = torch.empty((B, L, Hd), dtype=torch.float32, device=dev)
    delta = torch.empty((B, L, 3), dtype=torch.float32, device=dev)
    if B == 0 or L == 0:
        return agg, delta
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a.data_ptr(), bs.data_ptr(), x.data_ptr(), cmask.data_ptr(),
                 w_d.data_ptr(), w_e2.data_ptr(), b_e2.data_ptr(),
                 w_x1.data_ptr(), b_x1.data_ptr(), w_x2.data_ptr(),
                 b_x2.data_ptr(), agg.data_ptr(), delta.data_ptr(),
                 B, L, Hd, W, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err} "
                           f"({lib.egnn_band_fwd_error_string(err).decode()})")
    LAUNCHES[KERNEL] += 1
    return agg, delta


def egnn_band_fused(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                    W: int, use_pallas: object = "auto"
                    ) -> tuple[Tensor, Tensor]:
    """Routed entry of the decoder: the kernel where ``pallas_policy`` says
    so (``ops/routing.py``), else the plain version."""
    if pallas_policy(a, use_pallas):
        return egnn_band_fwd(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1,
                             w_x2, b_x2, W)
    return egnn_band_reference(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1,
                               w_x2, b_x2, W)
