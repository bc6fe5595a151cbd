"""Transformer encoder + hierarchical latent heads (counterpart of the JAX
package's ``models/encoder.py``).

Same architecture and parameter names: feature fusion
seq(d/2) || coord(d/4) || dihedral(d/4) -> geometric attention with nhead/2
heads and a learned residual scale (init 0.1) -> pre-norm transformer
layers with a ReLU FFN -> attention-pooled global latent + per-residue
local latent, logvar bias -2.

Parity details with Flax:
- ``LayerNorm`` eps is 1e-6 (torch's default is 1e-5);
- masks are True = attend;
- attention is written as plain tensor ops computing what Flax's
  ``dot_product_attention`` computes: q scaled by 1/sqrt(head_dim), masked
  logits filled with ``finfo.min`` (a row whose keys are all masked stays
  finite: uniform weights), softmax in fp32. ``scaled_dot_product_attention``
  is not used: it returns NaN on a fully masked row.
- ``dtype`` is the compute dtype (``models/init.py``): with bf16 every
  projection, attention product and LayerNorm output is bf16, parameters
  stay fp32, and ``mu`` / ``logvar`` come out bf16, as in the JAX package.
- Tensor parallelism (``parallel/mesh.py:shard_model``): each attention
  block keeps ``num_heads / tp`` heads (q/k/v column-parallel, ``out``
  row-parallel) and each FFN ``ff / tp`` hidden columns; dropout and the
  reparameterisation noise draw at the global shape (``parallel/shard.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from protein_ensemble_vae_torch.models.init import (Linear, layer_norm,
                                                    lecun_normal_, linear)
from protein_ensemble_vae_torch.parallel.shard import Dropout, randn

Tensor = torch.Tensor


def sinusoidal_pe(length: int, d_model: int, device=None,
                  dtype=torch.float32) -> Tensor:
    """Interleaved sin/cos positional table [length, d_model]."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / d_model))
    pe = torch.zeros((length, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


class MultiHeadDotProductAttention(nn.Module):
    """Flax ``nn.MultiHeadDotProductAttention`` (qkv and out width = d).

    ``query/key/value/out`` are ``nn.Linear(d, d)``; the bridge reshapes
    Flax's ``[d, heads, head_dim]`` / ``[heads, head_dim, d]`` kernels into
    them. Fresh weights follow Flax's init: lecun-normal, zero bias. Under
    tp (``tp`` set) it computes this rank's ``num_heads / tp`` heads.
    """

    tp = None

    def __init__(self, d: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if d % num_heads:
            raise ValueError(f"d={d} not divisible by num_heads={num_heads}")
        self.num_heads = num_heads
        self.query = Linear(d, d, dtype=dtype)
        self.key = Linear(d, d, dtype=dtype)
        self.value = Linear(d, d, dtype=dtype)
        self.out = Linear(d, d, dtype=dtype)
        for lin in (self.query, self.key, self.value, self.out):
            lecun_normal_(lin.weight, d)
            nn.init.zeros_(lin.bias)
        self.dropout = Dropout(dropout)

    def forward(self, inputs_q: Tensor, inputs_k: Tensor,
                mask: Optional[Tensor] = None) -> Tensor:
        """inputs_q [B, Lq, d], inputs_k [B, Lk, d]; mask [B, Lk] (True or
        1 = attend) -> [B, Lq, d]."""
        B, Lq, d = inputs_q.shape
        Lk = inputs_k.shape[1]
        hd = d // self.num_heads
        H = self.num_heads // (self.tp.size if self.tp is not None else 1)
        q = self.query(inputs_q).view(B, Lq, H, hd)
        k = self.key(inputs_k).view(B, Lk, H, hd)
        v = self.value(inputs_k).view(B, Lk, H, hd)
        q = q / math.sqrt(hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            keep = mask.bool()[:, None, None, :]
            logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
        # The softmax runs in fp32 also for bf16 logits (Flax's bf16 module
        # takes it in bf16, force_fp32_for_softmax=False): the weights are
        # rounded once, to bf16, instead of every step of the softmax, and a
        # fully masked row (all finfo(bf16).min) stays uniform.
        weights = F.softmax(logits.float(), dim=-1).to(q.dtype)
        weights = self.dropout(weights, self.tp, 1)
        o = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, Lq, H * hd)
        return self.out(o)


class TransformerEncoderLayer(nn.Module):
    """Pre-norm transformer layer, ReLU FFN: x += attn(LN(x)); x += ffn(LN(x))."""

    def __init__(self, d_model: int, nhead: int, ff: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = layer_norm(d_model, dtype)
        self.self_attn = MultiHeadDotProductAttention(d_model, nhead, dropout, dtype)
        self.norm2 = layer_norm(d_model, dtype)
        self.linear1 = linear(d_model, ff, dtype=dtype)
        self.linear2 = linear(ff, d_model, dtype=dtype)
        self.drop = Dropout(dropout)

    def forward(self, x: Tensor, mask: Optional[Tensor]) -> Tensor:
        h = self.norm1(x)
        h = self.self_attn(h, h, mask)
        x = x + self.drop(h)
        h = self.norm2(x)
        h = self.drop(F.relu(self.linear1(h)), self.linear1.tp, -1)
        h = self.linear2(h)
        return x + self.drop(h)


class DihedralAwareEncoder(nn.Module):
    """Feature fusion + geometric attention + transformer stack."""

    def __init__(self, seq_dim: int, d_model: int = 512, nhead: int = 8,
                 ff: int = 1024, nlayers: int = 6, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = d_model
        self.d_model = d
        self.coord_proj = linear(9, d // 4, dtype=dtype)
        self.coord_norm = layer_norm(d // 4, dtype)
        self.dihedral_proj = linear(6, d // 4, dtype=dtype)
        self.dihedral_norm = layer_norm(d // 4, dtype)
        self.seq_proj = linear(seq_dim, d // 2, dtype=dtype)
        self.fusion_dense = linear(d // 2 + 2 * (d // 4), d, dtype=dtype)
        self.fusion_norm = layer_norm(d, dtype)
        self.geom_res_scale = nn.Parameter(torch.tensor(0.1))
        self.geometric_attention = MultiHeadDotProductAttention(
            d, max(nhead // 2, 1), dropout, dtype)
        # named layer_{i}, as in the Flax tree, so parameter paths match
        self.nlayers = nlayers
        for i in range(nlayers):
            self.add_module(f"layer_{i}",
                            TransformerEncoderLayer(d, nhead, ff, dropout, dtype))
        self.final_norm = layer_norm(d, dtype)
        self.drop = Dropout(dropout)

    def forward(self, seq_emb: Tensor, n_coords: Tensor, ca_coords: Tensor,
                c_coords: Tensor, dihedrals: Tensor, mask: Tensor) -> Tensor:
        backbone = torch.cat([n_coords, ca_coords, c_coords], dim=-1)
        coord_feat = self.coord_norm(self.coord_proj(backbone))
        dih_feat = self.dihedral_norm(self.dihedral_proj(dihedrals))
        seq_feat = self.seq_proj(seq_emb)
        combined = torch.cat([seq_feat, coord_feat, dih_feat], dim=-1)
        feats = F.relu(self.fusion_norm(self.fusion_dense(combined)))
        feats = self.drop(feats)
        feats = feats + sinusoidal_pe(feats.shape[1], self.d_model,
                                      feats.device, feats.dtype)
        attn_out = self.geometric_attention(feats, feats, mask)
        feats = feats + self.geom_res_scale.to(feats.dtype) * attn_out
        for i in range(self.nlayers):
            feats = getattr(self, f"layer_{i}")(feats, mask)
        return self.final_norm(feats)


class HierLatent(nn.Module):
    """Hierarchical posterior heads: attention-pooled global + per-residue
    local."""

    def __init__(self, d_model: int, z_g: int = 512, z_l: int = 256,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.z_g, self.z_l = z_g, z_l
        self.dtype = dtype
        self.global_query = nn.Parameter(0.02 * torch.randn(1, 1, d_model))
        self.global_attention = MultiHeadDotProductAttention(d_model, 4, dropout, dtype)
        self.global_hidden = linear(d_model, 256, dtype=dtype)
        self.global_out = linear(256, 2 * z_g, logvar_bias_z=z_g, dtype=dtype)
        self.local_hidden = linear(d_model, 256, dtype=dtype)
        self.local_out = linear(256, 2 * z_l, logvar_bias_z=z_l, dtype=dtype)

    def forward(self, H: Tensor, mask: Tensor
                ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
        B = H.shape[0]
        q = self.global_query.expand(B, 1, -1).to(self.dtype)
        pooled = self.global_attention(q, H, mask)[:, 0]          # [B, d]
        g = self.global_out(F.relu(self.global_hidden(pooled)))
        mu_g, lv_g = torch.split(g, self.z_g, dim=-1)
        l = self.local_out(F.relu(self.local_hidden(H)))
        mu_l, lv_l = torch.split(l, self.z_l, dim=-1)
        return mu_g, lv_g, mu_l, lv_l


def reparam(mu: Tensor, lv: Tensor, generator: Optional[torch.Generator] = None,
            eps: Optional[Tensor] = None, rows: tuple[int, int] = (0, 1)) -> Tensor:
    """z = mu + eps * exp(0.5 * clip(lv, +-10)); the clip acts inside the
    exp only. ``eps`` ~ N(0, I) from ``generator`` in mu's dtype (the
    compute dtype, as the JAX side draws it) unless given: row shard
    ``rows`` of the draw at the global batch (``parallel/shard.randn``)."""
    if eps is None:
        eps = randn(mu.shape, rows, generator=generator, device=mu.device,
                    dtype=mu.dtype)
    return mu + eps * torch.exp(0.5 * torch.clamp(lv, -10.0, 10.0))


class ProteinEncoder(nn.Module):
    """DihedralAwareEncoder + HierLatent + reparameterization."""

    def __init__(self, seqemb_dim: int, d_model: int = 512, nhead: int = 8,
                 ff: int = 1024, nlayers: int = 6, z_g: int = 512,
                 z_l: int = 256, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.enc = DihedralAwareEncoder(seqemb_dim, d_model, nhead, ff,
                                        nlayers, dropout, dtype)
        self.latent = HierLatent(d_model, z_g, z_l, dropout, dtype)
        self.rows = (0, 1)      # row shard of the noise draws (draw_rows)

    def forward(self, seqemb: Tensor, n_coords: Tensor, ca_coords: Tensor,
                c_coords: Tensor, dihedrals: Tensor, mask: Tensor,
                generator: Optional[torch.Generator] = None,
                eps: Optional[tuple[Tensor, Tensor]] = None):
        """-> (z_g, z_l, mu_g, lv_g, mu_l, lv_l). ``eps`` = (eps_g, eps_l)
        replaces the draws from ``generator``."""
        H = self.enc(seqemb, n_coords, ca_coords, c_coords, dihedrals, mask)
        mu_g, lv_g, mu_l, lv_l = self.latent(H, mask)
        eps_g, eps_l = eps if eps is not None else (None, None)
        z_g = reparam(mu_g, lv_g, generator, eps_g, self.rows)
        z_l = reparam(mu_l, lv_l, generator, eps_l, self.rows)
        return z_g, z_l, mu_g, lv_g, mu_l, lv_l
