"""Steric-clash loss: the CUDA kernels of ``csrc/clash.cu`` (forward and
backward), their wrappers, their plain PyTorch versions, and
``ClashLossFunction``, the autograd function that joins them.

Counterpart of the JAX package's ``ops/pallas/clash.py``
(``clash_loss_pallas`` with its custom VJP). Over the interleaved N/CA/C
atoms a [B, 3L, 3] with atom mask m [B, 3L]:

    d_ij  = sqrt(|a_i - a_j|^2 + 1e-12)
    pm_ij = m_i m_j [|i//3 - j//3| >= 2]
    viol  = relu(clash_dist - d_ij)
    pen   = viol^2 / 2 below soft_margin, viol^2 above
    total_b = sum_{i<j} pm_ij pen_ij
    loss  = mean_b(total_b / (count_b + 1e-8))

``count_b`` (9 x the valid residue pairs at least 2 apart) is the closed
form ``pair_count``, a few tensor ops outside any kernel as in JAX. The
gradient takes no derivative through the mask.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from protein_ensemble_vae_torch.ops.kernels import LAUNCHES

Tensor = torch.Tensor

SOURCE = "clash"
CLASH_DIST, SOFT_MARGIN = 3.2, 0.5

_FN = None


def backbone_atoms(n: Tensor, ca: Tensor, c: Tensor, mask: Tensor
                   ) -> tuple[Tensor, Tensor]:
    """[B, L, 3] x 3 + mask [B, L] -> atoms [B, 3L, 3] (N, CA, C
    interleaved) and atom mask [B, 3L]."""
    B, L = ca.shape[:2]
    atoms = torch.stack([n, ca, c], dim=2).reshape(B, 3 * L, 3)
    return atoms, torch.repeat_interleave(mask, 3, dim=1)


def clash_pair_terms(atoms: Tensor, amask: Tensor,
                     clash_dist: float = CLASH_DIST,
                     soft_margin: float = SOFT_MARGIN) -> tuple[Tensor, Tensor]:
    """Plain version: the dense [B, 3L, 3L] formulation. Returns the
    per-sample penalty sum over the upper triangle and its pair count."""
    A = atoms.shape[1]
    diff = atoms[:, :, None, :] - atoms[:, None, :, :]
    dists = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    res_idx = torch.arange(A, device=atoms.device) // 3
    sep = (torch.abs(res_idx[:, None] - res_idx[None, :]) >= 2).to(atoms.dtype)
    triu = torch.triu(torch.ones((A, A), dtype=atoms.dtype,
                                 device=atoms.device), diagonal=1)
    pair_mask = amask[:, :, None] * amask[:, None, :] * (sep * triu)[None]
    viol = torch.relu(clash_dist - dists)
    pen = torch.where(viol < soft_margin, 0.5 * viol * viol, viol * viol)
    return (torch.sum(pen * pair_mask, dim=(1, 2)),
            torch.sum(pair_mask, dim=(1, 2)))


def clash_fwd_reference(atoms, amask, clash_dist=CLASH_DIST,
                        soft_margin=SOFT_MARGIN) -> Tensor:
    """Plain version of the forward kernel: totals [B]."""
    return clash_pair_terms(atoms, amask, clash_dist, soft_margin)[0]


def clash_bwd_reference(atoms, amask, scale, clash_dist=CLASH_DIST,
                        soft_margin=SOFT_MARGIN) -> Tensor:
    """Plain version of the backward kernel: scale[b] * d total_b / d atoms,
    by torch autograd through ``clash_fwd_reference``."""
    a = atoms.detach().requires_grad_(True)
    with torch.enable_grad():
        totals = clash_fwd_reference(a, amask, clash_dist, soft_margin)
        return torch.autograd.grad(totals, a, scale)[0]


def pair_count(mask: Tensor) -> Tensor:
    """9 x the number of residue pairs i < j - 1 with both valid, per
    sample (closed form, O(L))."""
    m = mask.to(torch.float32)
    cum = torch.cumsum(m, dim=1)
    before = torch.nn.functional.pad(cum, (2, 0))[:, :-2]   # cum[j - 2]
    return 9.0 * torch.sum(m * before, dim=1)


def _kernel_fn():
    global _FN
    if _FN is None:
        from protein_ensemble_vae_torch.ops.kernels.build import load_library

        lib = load_library(SOURCE)
        lib.clash_fwd_f32.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                                      + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.clash_fwd_f32.restype = ctypes.c_int
        lib.clash_bwd_f32.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                                      + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.clash_bwd_f32.restype = ctypes.c_int
        lib.clash_n_tiles.argtypes = [ctypes.c_int]
        lib.clash_n_tiles.restype = ctypes.c_int
        lib.clash_error_string.argtypes = [ctypes.c_int]
        lib.clash_error_string.restype = ctypes.c_char_p
        _FN = lib
    return _FN


def _check(atoms: Tensor, amask: Tensor) -> None:
    B, A = amask.shape
    for name, t, shape in (("atoms", atoms, (B, A, 3)), ("amask", amask, (B, A))):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != atoms.device:
            raise ValueError(f"{name} lies on {t.device}, expected {atoms.device}")


def _raise_on(lib, err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} "
                           f"({lib.clash_error_string(err).decode()})")


def clash_fwd(atoms: Tensor, amask: Tensor, clash_dist: float = CLASH_DIST,
              soft_margin: float = SOFT_MARGIN) -> Tensor:
    """The forward kernel's wrapper: totals [B]. For CPU tensors it is the
    plain version; for CUDA tensors it launches the kernel on the current
    stream or raises."""
    if not atoms.is_cuda:
        return clash_fwd_reference(atoms, amask, clash_dist, soft_margin)
    _check(atoms, amask)
    B, A = amask.shape
    lib = _kernel_fn()
    totals = torch.empty((B,), dtype=torch.float32, device=atoms.device)
    if B == 0 or A == 0:
        return totals.zero_()
    partial = torch.empty((B * lib.clash_n_tiles(A),), dtype=torch.float32,
                          device=atoms.device)
    with torch.cuda.device(atoms.device):
        stream = torch.cuda.current_stream(atoms.device).cuda_stream
        err = lib.clash_fwd_f32(atoms.data_ptr(), amask.data_ptr(),
                                partial.data_ptr(), totals.data_ptr(), B, A,
                                clash_dist, soft_margin, stream)
    _raise_on(lib, err, "clash_fwd")
    LAUNCHES["clash_fwd"] += 1
    return totals


def clash_bwd(atoms: Tensor, amask: Tensor, scale: Tensor,
              clash_dist: float = CLASH_DIST,
              soft_margin: float = SOFT_MARGIN) -> Tensor:
    """The backward kernel's wrapper: scale[b] * d total_b / d atoms,
    [B, 3L, 3]. For CPU tensors it is the plain version; for CUDA tensors
    it launches the kernel on the current stream or raises."""
    if not atoms.is_cuda:
        return clash_bwd_reference(atoms, amask, scale, clash_dist, soft_margin)
    _check(atoms, amask)
    B, A = amask.shape
    scale = scale.to(torch.float32).contiguous()
    if tuple(scale.shape) != (B,) or scale.device != atoms.device:
        raise ValueError(f"scale must be [{B}] on {atoms.device}")
    lib = _kernel_fn()
    grad = torch.empty((B, A, 3), dtype=torch.float32, device=atoms.device)
    if B == 0 or A == 0:
        return grad
    with torch.cuda.device(atoms.device):
        stream = torch.cuda.current_stream(atoms.device).cuda_stream
        err = lib.clash_bwd_f32(atoms.data_ptr(), amask.data_ptr(),
                                scale.data_ptr(), grad.data_ptr(), B, A,
                                clash_dist, soft_margin, stream)
    _raise_on(lib, err, "clash_bwd")
    LAUNCHES["clash_bwd"] += 1
    return grad


class ClashLossFunction(torch.autograd.Function):
    """Kernel 3 forward, kernel 4 backward; saves the atoms, the atom mask
    and the pair counts, as the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, n, ca, c, mask, clash_dist, soft_margin):
        atoms, amask = backbone_atoms(n, ca, c, mask.to(torch.float32))
        atoms = atoms.to(torch.float32).contiguous()
        amask = amask.contiguous()
        totals = clash_fwd(atoms, amask, clash_dist, soft_margin)
        counts = pair_count(mask)
        ctx.save_for_backward(atoms, amask, counts)
        ctx.params = (clash_dist, soft_margin)
        return torch.mean(totals / (counts + 1e-8))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        atoms, amask, counts = ctx.saved_tensors
        B = counts.shape[0]
        scale = g / (B * (counts + 1e-8))
        grad = clash_bwd(atoms, amask, scale, *ctx.params)
        grad = grad.reshape(B, -1, 3, 3)
        return grad[:, :, 0], grad[:, :, 1], grad[:, :, 2], None, None, None


def clash_loss_kernel(n: Tensor, ca: Tensor, c: Tensor, mask: Tensor,
                      clash_dist: float = CLASH_DIST,
                      soft_margin: float = SOFT_MARGIN) -> Tensor:
    """The clash loss through kernels 3 and 4 (same value as the dense
    ``losses.clash_loss`` to fp32 tolerance, O(L) memory)."""
    return ClashLossFunction.apply(n, ca, c, mask, clash_dist, soft_margin)
