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

``count_b`` is 9 x the valid residue pairs at least 2 apart. The kernels
read n, ca, c [B, L, 3] and the mask [B, L] as they lie: the forward
launch returns the loss with ``total_b`` and ``count_b``, the backward
launch forms the gradient's scale from the upstream gradient and the
counts itself. The gradient takes no derivative through the mask.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from protein_ensemble_vae_torch.ops.kernels import LAUNCHES, check_outputs

Tensor = torch.Tensor

SOURCE = "clash"
CLASH_DIST, SOFT_MARGIN = 3.2, 0.5

# What the wrappers size launches and scratch by: the tile of csrc/clash.cu
# (TR there) and the floats of one backward partial (SLOT there).
TILE = 32            # residues per tile; a block takes one pair of tiles
SLOT = 9 * TILE
SPLIT_BUDGET = 1056  # blocks x split at most this (8 per SM on 132 SMs)

_LIB = None
_TICKETS: dict = {}
# Counters that a larger launch outgrew: kept alive, because a CUDA graph
# captured earlier holds their address and writes them at every replay.
_OUTGROWN: list = []
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


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
    """Plain version of the forward kernel's penalty sums: totals [B]."""
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


# ---------------------------------------------------------------------------
# Work plan: grid and scratch sizes (the kernels derive the same grids from
# B and L and map a forward block to its tiles themselves)
# ---------------------------------------------------------------------------

def n_tiles(L: int) -> int:
    return -(-L // TILE)


def fwd_grid(B: int, L: int) -> tuple[int, int]:
    """Forward grid (pairs of tiles I <= J, samples)."""
    T = n_tiles(L)
    return T * (T + 1) // 2, B


def bwd_grid(B: int, L: int) -> tuple[int, int, int]:
    """Backward grid (J tiles, I tiles, samples): block (J, I, b) owns the
    gradient of tile I against tile J."""
    T = n_tiles(L)
    return T, T, B


def block_split(blocks: int) -> int:
    """Warps per J group of a block (1, 2 or 4; a block has 128 x split
    threads): the most that keeps blocks x split within SPLIT_BUDGET, so a
    small grid still puts several warps on each scheduler."""
    for split in (4, 2):
        if blocks * split <= SPLIT_BUDGET:
            return split
    return 1


def scratch_floats(B: int, L: int) -> tuple[int, int]:
    """Scratch floats of the forward (partials + per-sample ratios) and of
    the backward (one SLOT per block)."""
    P = fwd_grid(B, L)[0]
    T = n_tiles(L)
    return 2 * B * P + B, B * T * T * SLOT


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    global _LIB
    if _LIB is None:
        from protein_ensemble_vae_torch.ops.kernels.build import load_library

        lib = load_library(SOURCE)
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        tail = [i32] * 3 + [i64] * 5 + [f32, f32, ptr]
        lib.clash_fwd_f32.argtypes = [ptr] * 7 + tail
        lib.clash_bwd_f32.argtypes = [ptr] * 9 + tail
        lib.clash_noop.argtypes = [ptr]
        for fn in (lib.clash_fwd_f32, lib.clash_bwd_f32, lib.clash_noop):
            fn.restype = ctypes.c_int
        lib.clash_error_string.argtypes = [ctypes.c_int]
        lib.clash_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _stream(index: int) -> int:
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def _tickets(device: int, stream: int, n: int) -> int:
    """Address of the launch counters of (device, stream): zero at
    allocation, left zero by every launch; kernels on one stream run in
    order."""
    key = (device, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        if t is not None:
            _OUTGROWN.append(t)
        t = torch.zeros((max(n, 256),), dtype=torch.int32, device=torch.device("cuda", device))
        _TICKETS[key] = t
    return t.data_ptr()


@functools.lru_cache(maxsize=256)
def _plan(B: int, L: int) -> tuple[int, int, int, int, int]:
    """(forward split, backward split, tiles, forward scratch floats,
    backward scratch floats) of a launch."""
    T = n_tiles(L)
    fwd_scr, bwd_scr = scratch_floats(B, L)
    return (block_split(math.prod(fwd_grid(B, L))), block_split(B * T * T), T,
            fwd_scr, bwd_scr)


def _check(n: Tensor, ca: Tensor, c: Tensor, mask: Tensor) -> tuple[int, int, int]:
    """B, L and the device index of the inputs; raises on a wrong dtype,
    shape, device or stride."""
    if mask.dim() != 2:
        raise ValueError(f"mask must be [B, L], got {tuple(mask.shape)}")
    B, L = mask.shape
    dev = ca.get_device()
    if not n.dtype is ca.dtype is c.dtype is mask.dtype is torch.float32:
        raise ValueError(f"n, ca, c and mask must be float32, got "
                         f"{[t.dtype for t in (n, ca, c, mask)]}")
    if not n.get_device() == dev == c.get_device() == mask.get_device():
        raise ValueError(f"n, ca, c and mask lie on devices "
                         f"{[t.device for t in (n, ca, c, mask)]}")
    if not n.shape == ca.shape == c.shape == (B, L, 3):
        raise ValueError(f"n, ca, c have shapes {[tuple(t.shape) for t in (n, ca, c)]}, "
                         f"expected {(B, L, 3)}")
    if not n.stride() == ca.stride() == c.stride():
        raise ValueError("n, ca and c must share strides")
    return B, L, dev


def _launch(fn, args, device: int, kernel: str) -> None:
    """Launch on the current stream of ``device``; raise on a CUDA error."""
    if device == torch.cuda.current_device():
        err = fn(*args, _stream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, _stream(device))
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} "
                           f"({_lib().clash_error_string(err).decode()})")
    LAUNCHES[kernel] += 1


def _plain_fwd(n, ca, c, mask, clash_dist, soft_margin):
    atoms, amask = backbone_atoms(n, ca, c, mask)
    totals = clash_fwd_reference(atoms, amask, clash_dist, soft_margin)
    counts = pair_count(mask)
    return torch.mean(totals / (counts + 1e-8)), totals, counts


def _aligned(floats: int) -> int:
    """``floats`` rounded up to 64 (256 bytes), where a scratch area starts."""
    return -(-floats // 64) * 64


def clash_fwd(n: Tensor, ca: Tensor, c: Tensor, mask: Tensor,
              clash_dist: float = CLASH_DIST, soft_margin: float = SOFT_MARGIN
              ) -> tuple[Tensor, Tensor, Tensor]:
    """The forward kernel's wrapper: (loss, totals [B], counts [B]) from
    n, ca, c [B, L, 3] (fp32, one set of strides) and mask [B, L] (fp32).
    For CPU tensors it is the plain version; for CUDA tensors it launches
    the kernel on the current stream or raises."""
    if not ca.is_cuda:
        return _plain_fwd(n, ca, c, mask, clash_dist, soft_margin)
    B, L, dev = _check(n, ca, c, mask)
    if B == 0 or L == 0:
        out = torch.zeros((1 + 2 * B,), dtype=torch.float32, device=ca.device)
        return out[0], out[1:1 + B], out[1 + B:]
    split, _, _, scr, _ = _plan(B, L)
    head = _aligned(1 + 2 * B)
    buf = torch.empty((head + scr,), dtype=torch.float32, device=ca.device)
    ptr = buf.data_ptr()
    _launch(_lib().clash_fwd_f32,
            (n.data_ptr(), ca.data_ptr(), c.data_ptr(), mask.data_ptr(), ptr, ptr + 4 * head,
             _tickets(dev, _stream(dev), 1), B, L, split, *ca.stride(), *mask.stride(),
             clash_dist, soft_margin), dev, "clash_fwd")
    return buf[0], buf[1:1 + B], buf[1 + B:1 + 2 * B]


def clash_bwd(n: Tensor, ca: Tensor, c: Tensor, mask: Tensor, g: Tensor,
              counts: Tensor, clash_dist: float = CLASH_DIST,
              soft_margin: float = SOFT_MARGIN) -> tuple[Tensor, Tensor, Tensor]:
    """The backward kernel's wrapper: (dn, dca, dc), each [B, L, 3], the
    gradient of the loss times the upstream scalar ``g``, given the
    forward's ``counts`` [B]. For CPU tensors it is the plain version; for
    CUDA tensors it launches the kernel on the current stream or raises."""
    if not ca.is_cuda:
        B = mask.shape[0]
        atoms, amask = backbone_atoms(n, ca, c, mask)
        scale = g / (B * (counts + 1e-8))
        grad = clash_bwd_reference(atoms, amask, scale, clash_dist, soft_margin)
        return grad.reshape(B, -1, 3, 3).unbind(2)
    B, L, dev = _check(n, ca, c, mask)
    if not (g.dtype is counts.dtype is torch.float32 and g.numel() == 1
            and g.get_device() == dev == counts.get_device()
            and counts.shape == (B,) and counts.is_contiguous()):
        raise ValueError(f"g must be one float32 and counts [{B}] contiguous float32, "
                         f"both on the inputs' device")
    _, split, T, _, scr = _plan(B, L)
    head = _aligned(9 * B * L)
    buf = torch.empty((head + scr,), dtype=torch.float32, device=ca.device)
    grad = buf[:9 * B * L].view(3, B, L, 3)
    if B == 0 or L == 0:
        return grad.unbind(0)
    ptr = buf.data_ptr()
    _launch(_lib().clash_bwd_f32,
            (n.data_ptr(), ca.data_ptr(), c.data_ptr(), mask.data_ptr(), g.data_ptr(),
             counts.data_ptr(), ptr, ptr + 4 * head, _tickets(dev, _stream(dev), B * T),
             B, L, split, *ca.stride(), *mask.stride(), clash_dist, soft_margin),
            dev, "clash_bwd")
    return grad.unbind(0)


def clash_noop() -> None:
    """Launch the source's empty kernel on the current device and stream
    through the same path: the launch floor that timings of kernels 3-4
    are read against. Counts nothing."""
    err = _lib().clash_noop(_stream(torch.cuda.current_device()))
    if err != 0:
        raise RuntimeError(f"clash_noop launch failed: CUDA error {err}")


class ClashLossFunction(torch.autograd.Function):
    """Kernel 3 forward, kernel 4 backward; saves the backbone, the mask and
    the pair counts, as the JAX custom VJP saves atoms, mask and counts."""

    @staticmethod
    def forward(ctx, n, ca, c, mask, clash_dist, soft_margin):
        n, ca, c = (t.to(torch.float32) for t in (n, ca, c))
        if not n.stride() == ca.stride() == c.stride():
            n, ca, c = n.contiguous(), ca.contiguous(), c.contiguous()
        mask = mask.to(torch.float32)
        loss, _, counts = clash_fwd(n, ca, c, mask, clash_dist, soft_margin)
        check_outputs("clash_fwd", loss)
        ctx.save_for_backward(n, ca, c, mask, counts)
        ctx.params = (clash_dist, soft_margin)
        return loss

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        n, ca, c, mask, counts = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        dn, dca, dc = clash_bwd(n, ca, c, mask, g, counts, *ctx.params)
        check_outputs("clash_bwd", dn, dca, dc)
        return dn, dca, dc, None, None, None


def clash_loss_kernel(n: Tensor, ca: Tensor, c: Tensor, mask: Tensor,
                      clash_dist: float = CLASH_DIST,
                      soft_margin: float = SOFT_MARGIN) -> Tensor:
    """The clash loss through kernels 3 and 4 (same value as the dense
    ``losses.clash_loss`` to fp32 tolerance, O(L) memory, one launch each
    way)."""
    return ClashLossFunction.apply(n, ca, c, mask, clash_dist, soft_margin)
