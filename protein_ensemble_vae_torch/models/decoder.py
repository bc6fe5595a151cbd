"""E(n)-equivariant GNN decoder over a dense neighbor band (counterpart of
the JAX package's ``models/decoder.py``).

The |i-j| <= W window graph over valid residues is a dense [B, L, 2W+1]
band over mask-compacted sequences:

1. ``compact_valid`` permutes each row valid-first (stable), so the window
   graph on compacted indices is the graph over valid residues.
2. Message passing runs in ``ops.kernels.egnn_band``: the CUDA kernel for
   CUDA tensors, the kernel's plain version for CPU tensors
   (``ops/routing.py``); with ``use_pallas=False``, in ``band_chain``
   with the edge chain in the compute dtype, as the JAX package's XLA band
   path runs it.
3. The edge MLP's first layer is split algebraically:
   ``W.[h_i, h_j, d^2] = W_i.h_i + W_j.h_j + w_d.d^2``.
4. Results scatter back through the inverse permutation; padded positions
   emit zeros.

The EGNN edge weights stay raw parameters in the JAX package's [in, out]
layout, the layout the kernel reads. ``dtype`` is the compute dtype
(``models/init.py``): with bf16, ``zc``, ``h`` and the projections ``a_i`` /
``b_j`` are bf16; ``l2c_out``, ``seq_out``, ``n_off2`` and ``c_off2``
compute in fp32 from their bf16 input, and the coordinates stay fp32. The
band kernels then read bf16 ``a_i`` / ``b_j`` and make one-pass TF32
products (``precision="default"``, JAX ``None``), with the chain in fp32.

Tensor parallelism (``parallel/mesh.py:shard_model``, ``tp`` set on each
layer): the edge chain splits as a Megatron MLP, the JAX package's layout.
``phi_e1_{hi,hj,d2}``, ``phi_x1`` and ``phi_h1`` keep ``hidden / tp`` output
columns, ``phi_e2``, ``phi_x2`` and ``phi_h2`` as many input rows, whose
partial products are summed over the tp group (``band_chain``'s ``tp``).
Only the plain band path shards: the band kernels are single-device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from protein_ensemble_vae_torch.models.init import layer_norm, linear, uniform_
from protein_ensemble_vae_torch.ops.geometry import (compact_valid, safe_norm,
                                                     safe_normalize,
                                                     scatter_compact)
from protein_ensemble_vae_torch.ops.kernels.egnn_band import (band_chain,
                                                              band_indices,
                                                              egnn_band_fused)
from protein_ensemble_vae_torch.parallel.shard import Dropout, copy_to_tp

Tensor = torch.Tensor

BOND_N_CA = 1.46
BOND_CA_C = 1.52
BOND_C_N = 1.33


def _param(shape, fan_in: int) -> nn.Parameter:
    return nn.Parameter(uniform_(torch.empty(shape), fan_in))


class EGNNBandLayer(nn.Module):
    """One EGNN layer over a dense neighbor band.

    phi_e: [h_i, h_j, |x_i-x_j|^2] -> message (2-layer SiLU MLP, split first layer)
    phi_h: [h_i, sum_j m_ij] -> residual node update + LayerNorm
    phi_x: m_ij -> scalar w_ij; x_i += 0.2 * deg^-1 * sum_j w_ij (x_i - x_j)
    """

    tp = None

    def __init__(self, hidden_in: int, hidden: int, use_pallas: object = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        Hin, Hd = hidden_in, hidden
        self.use_pallas = use_pallas
        self.dtype = dtype
        # The split first layer is one matrix W[2H+1, Hd]: all three pieces
        # and the bias use the JOINT fan-in.
        fan_e1 = 2 * Hin + 1
        self.phi_e1_hi_kernel = _param((Hin, Hd), fan_e1)
        self.phi_e1_hi_bias = _param((Hd,), fan_e1)
        self.phi_e1_hj_kernel = _param((Hin, Hd), fan_e1)
        self.phi_e1_d2_kernel = _param((1, Hd), fan_e1)
        self.phi_e2_kernel = _param((Hd, Hd), Hd)
        self.phi_e2_bias = _param((Hd,), Hd)
        self.phi_x1_kernel = _param((Hd, Hd), Hd)
        self.phi_x1_bias = _param((Hd,), Hd)
        self.phi_x2_kernel = _param((Hd, 1), Hd)
        self.phi_x2_bias = _param((1,), Hd)
        self.phi_h1 = linear(Hin + Hd, Hd, dtype=dtype)
        self.phi_h2 = linear(Hd, Hin, dtype=dtype)
        self.norm_h = layer_norm(Hin, dtype)

    def forward(self, h: Tensor, x: Tensor, nbr_idx: Tensor, nbr_valid: Tensor,
                deg_inv: Tensor, cmask: Tensor) -> tuple[Tensor, Tensor]:
        dt, tp = self.dtype, self.tp
        hc = h.to(dt)
        b_hi, b_x1 = self.phi_e1_hi_bias, self.phi_x1_bias
        if tp is not None:      # column-parallel: this rank's bias columns
            b_hi, b_x1 = (tp.chunk(copy_to_tp(b, tp), 0) for b in (b_hi, b_x1))
        hf = copy_to_tp(hc, tp)
        a_i = hf @ self.phi_e1_hi_kernel.to(dt) + b_hi.to(dt)
        b_j = hf @ self.phi_e1_hj_kernel.to(dt)
        edge = (self.phi_e1_d2_kernel, self.phi_e2_kernel, self.phi_e2_bias,
                self.phi_x1_kernel, b_x1, self.phi_x2_kernel, self.phi_x2_bias)
        if not self.use_pallas:
            agg, raw_delta = band_chain(a_i, b_j, x, nbr_idx, nbr_valid, *edge, dt,
                                        tp)
        else:
            # the kernel (or, for CPU tensors, its plain version): fp32
            # chain; an fp32 model's products at fp32 accuracy, a bf16
            # model's in one TF32 pass, as the JAX side's precision
            W = (nbr_idx.shape[1] - 1) // 2
            precision = "highest" if dt == torch.float32 else "default"
            agg, raw_delta = egnn_band_fused(a_i, b_j, x, cmask, *edge, W,
                                             self.use_pallas, precision)
            agg = agg.to(dt)
        hu = F.silu(self.phi_h1(torch.cat([hc, agg], dim=-1)))
        hu = self.phi_h2(hu)
        h = self.norm_h(h + hu)
        x = x + raw_delta.to(x.dtype) * deg_inv[..., None] * 0.2
        return h, x


class EGNNDecoder(nn.Module):
    """Latent -> initial CA coords -> EGNN refinement -> backbone + sequence
    logits (hidden 256, 8 layers, max_neighbors 40 by default)."""

    def __init__(self, z_g: int, z_l: int, hidden: int = 256,
                 num_layers: int = 8, max_neighbors: int = 40,
                 dropout: float = 0.1, degree_normalize: bool = True,
                 remat: bool = False, use_pallas: object = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_layers = num_layers
        self.remat = remat
        self.max_neighbors = max_neighbors
        self.degree_normalize = degree_normalize
        zc = z_g + z_l
        self.l2c_dense1 = linear(zc, hidden, dtype=dtype)
        self.l2c_norm = layer_norm(hidden, dtype)
        self.l2c_dense2 = linear(hidden, hidden // 2, dtype=dtype)
        self.l2c_out = linear(hidden // 2, 3, kernel_scale=0.1, zero_bias=True)
        self.input_embedding = linear(zc, hidden, dtype=dtype)
        # named egnn_{i}, as in the Flax tree, so parameter paths match
        for i in range(num_layers):
            self.add_module(f"egnn_{i}",
                            EGNNBandLayer(hidden, hidden, use_pallas, dtype))
        self.seq_dense1 = linear(hidden, hidden * 2, dtype=dtype)
        self.seq_norm1 = layer_norm(hidden * 2, dtype)
        self.seq_dense2 = linear(hidden * 2, hidden, dtype=dtype)
        self.seq_norm2 = layer_norm(hidden, dtype)
        self.seq_out = linear(hidden, 20)
        self.n_off1 = linear(hidden, hidden // 2, dtype=dtype)
        self.n_off2 = linear(hidden // 2, 4)
        self.c_off1 = linear(hidden, hidden // 2, dtype=dtype)
        self.c_off2 = linear(hidden // 2, 4)
        self.drop = Dropout(dropout)
        self.drop_half = Dropout(dropout * 0.5)

    def forward(self, z_g: Tensor, z_l: Tensor, mask: Optional[Tensor] = None
                ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
        B, L, _ = z_l.shape
        if mask is None:
            mask = torch.ones((B, L), dtype=torch.float32, device=z_l.device)
        mask = mask.to(torch.float32)

        pos, inv_pos, cmask = compact_valid(mask)
        zl_c = torch.gather(z_l, 1, pos[..., None].expand(-1, -1, z_l.shape[-1]))
        zg_rep = z_g[:, None, :].expand(B, L, z_g.shape[-1])
        zc = torch.cat([zg_rep, zl_c], dim=-1).to(self.dtype)

        t = F.relu(self.l2c_norm(self.l2c_dense1(zc)))
        t = self.drop_half(t)
        t = F.relu(self.l2c_dense2(t))
        x = self.l2c_out(t).to(torch.float32)                   # [B, L, 3]

        h = self.input_embedding(zc)

        W = self.max_neighbors
        nbr_idx, in_range = band_indices(L, W, z_l.device)
        cm = cmask > 0.5
        nbr_valid = in_range[None] & cm[:, :, None] & cm[:, nbr_idx]
        deg = nbr_valid.sum(-1).to(torch.float32)
        if self.degree_normalize:
            deg_inv = 1.0 / torch.clamp(deg, min=1.0)
        else:
            deg_inv = torch.ones_like(deg)

        for i in range(self.num_layers):
            layer = getattr(self, f"egnn_{i}")
            if self.remat and torch.is_grad_enabled():
                # Remat (ModelConfig.decoder_remat): keep only the layer's
                # inputs and recompute it in the backward. The band kernel's
                # forward then runs twice per layer per training step.
                h, x = checkpoint(layer, h, x, nbr_idx, nbr_valid, deg_inv,
                                  cmask, use_reentrant=False)
            else:
                h, x = layer(h, x, nbr_idx, nbr_valid, deg_inv, cmask)
            h = self.drop(h)

        s = F.relu(self.seq_norm1(self.seq_dense1(h)))
        s = self.drop_half(s)
        s = F.relu(self.seq_norm2(self.seq_dense2(s)))
        s = self.drop_half(s)
        seq_logits = self.seq_out(s)

        n_head = self.n_off2(F.relu(self.n_off1(h)))
        c_head = self.c_off2(F.relu(self.c_off1(h)))
        x_n = x + safe_normalize(n_head[..., :3]) * BOND_N_CA
        x_c = x + safe_normalize(c_head[..., :3]) * BOND_CA_C

        # Soft peptide-bond projection: 3 iterations pulling N(i+1) toward
        # 1.33 A from C(i), 15 %/iter, clamp [0.90, 1.10] — over consecutive
        # *valid* residues (compacted arrays).
        if L > 1:
            for _ in range(3):
                vec = x_n[:, 1:] - x_c[:, :-1]
                dist = safe_norm(vec, keepdim=True)
                scale = 1.0 + 0.15 * (BOND_C_N / (dist + 1e-8) - 1.0)
                scale = torch.clamp(scale, 0.90, 1.10)
                x_n = torch.cat([x_n[:, :1], x_c[:, :-1] + vec * scale], dim=1)

        out_n = scatter_compact(x_n, inv_pos, mask)
        out_ca = scatter_compact(x, inv_pos, mask)
        out_c = scatter_compact(x_c, inv_pos, mask)
        out_seq = scatter_compact(seq_logits, inv_pos, mask)
        return out_n, out_ca, out_c, out_seq
