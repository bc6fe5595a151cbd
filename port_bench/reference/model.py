"""The hierarchical CVAE, plain PyTorch: a frozen copy of the port's
``models/`` (``init.py``, ``encoder.py``, ``decoder.py``, ``vae.py``) at the
fp32 compute dtype, on one device, with the EGNN band layers on their plain
band-gather formulation in place of kernels 1-2.

Parameter names are the port's, so one state dict loads into both. Random
draws are the port's, call for call: ``Dropout`` draws a bool keep mask at
the tensor's shape from the device's default generator, and the
reparameterisation noise comes from ``generator`` unless ``eps`` is given.
So a run seeded as the port's train step seeds it draws the same bits.

The band chain materialises [B, rows, 2W + 1, hidden] edge tensors. It runs
in blocks of ``BAND_ROWS`` receivers, each recomputed in the backward
(``torch.utils.checkpoint``; it draws nothing), so a batch of 16 chains of
640 residues at width 512 fits beside the rest of the step.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from port_bench.reference.geometry import (compact_valid, safe_norm,
                                           safe_normalize, scatter_compact)

Tensor = torch.Tensor

LN_EPS = 1e-6
BOND_N_CA = 1.46
BOND_CA_C = 1.52
BOND_C_N = 1.33
BAND_ROWS = 128


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def uniform_(t: Tensor, fan_in: int, scale: float = 1.0) -> Tensor:
    bound = scale / math.sqrt(fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound)


def linear(i: int, o: int) -> nn.Linear:
    return nn.Linear(i, o)


def layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


class Dropout(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: Tensor) -> Tensor:
        if not self.training or self.p == 0:
            return x
        keep = torch.empty(x.shape, dtype=torch.bool, device=x.device).bernoulli_(1.0 - self.p)
        return (x * keep).mul_(1.0 / (1.0 - self.p))


def sinusoidal_pe(length: int, d_model: int, device=None) -> Tensor:
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros((length, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class MultiHeadDotProductAttention(nn.Module):
    """Flax's attention: q scaled by 1/sqrt(head_dim), masked logits set to
    finfo.min (a fully masked row stays uniform), softmax, dropout on the
    weights."""

    def __init__(self, d: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.query, self.key, self.value, self.out = (nn.Linear(d, d) for _ in range(4))
        self.dropout = Dropout(dropout)

    def forward(self, inputs_q: Tensor, inputs_k: Tensor,
                mask: Optional[Tensor] = None) -> Tensor:
        B, Lq, d = inputs_q.shape
        Lk = inputs_k.shape[1]
        H = self.num_heads
        hd = d // H
        q = self.query(inputs_q).view(B, Lq, H, hd) / math.sqrt(hd)
        k = self.key(inputs_k).view(B, Lk, H, hd)
        v = self.value(inputs_k).view(B, Lk, H, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            keep = mask.bool()[:, None, None, :]
            logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
        weights = self.dropout(F.softmax(logits, dim=-1))
        o = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, Lq, d)
        return self.out(o)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, ff: int, dropout: float):
        super().__init__()
        self.norm1 = layer_norm(d_model)
        self.self_attn = MultiHeadDotProductAttention(d_model, nhead, dropout)
        self.norm2 = layer_norm(d_model)
        self.linear1 = linear(d_model, ff)
        self.linear2 = linear(ff, d_model)
        self.drop = Dropout(dropout)

    def forward(self, x: Tensor, mask: Optional[Tensor]) -> Tensor:
        h = self.norm1(x)
        h = self.self_attn(h, h, mask)
        x = x + self.drop(h)
        h = self.norm2(x)
        h = self.drop(F.relu(self.linear1(h)))
        h = self.linear2(h)
        return x + self.drop(h)


class DihedralAwareEncoder(nn.Module):
    def __init__(self, seq_dim: int, d_model: int, nhead: int, ff: int,
                 nlayers: int, dropout: float):
        super().__init__()
        d = self.d_model = d_model
        self.coord_proj = linear(9, d // 4)
        self.coord_norm = layer_norm(d // 4)
        self.dihedral_proj = linear(6, d // 4)
        self.dihedral_norm = layer_norm(d // 4)
        self.seq_proj = linear(seq_dim, d // 2)
        self.fusion_dense = linear(d // 2 + 2 * (d // 4), d)
        self.fusion_norm = layer_norm(d)
        self.geom_res_scale = nn.Parameter(torch.tensor(0.1))
        self.geometric_attention = MultiHeadDotProductAttention(d, max(nhead // 2, 1), dropout)
        self.nlayers = nlayers
        for i in range(nlayers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(d, nhead, ff, dropout))
        self.final_norm = layer_norm(d)
        self.drop = Dropout(dropout)

    def forward(self, seq_emb, n_coords, ca_coords, c_coords, dihedrals, mask):
        backbone = torch.cat([n_coords, ca_coords, c_coords], dim=-1)
        coord_feat = self.coord_norm(self.coord_proj(backbone))
        dih_feat = self.dihedral_norm(self.dihedral_proj(dihedrals))
        seq_feat = self.seq_proj(seq_emb)
        combined = torch.cat([seq_feat, coord_feat, dih_feat], dim=-1)
        feats = self.drop(F.relu(self.fusion_norm(self.fusion_dense(combined))))
        feats = feats + sinusoidal_pe(feats.shape[1], self.d_model, feats.device)
        attn_out = self.geometric_attention(feats, feats, mask)
        feats = feats + self.geom_res_scale * attn_out
        for i in range(self.nlayers):
            feats = getattr(self, f"layer_{i}")(feats, mask)
        return self.final_norm(feats)


class HierLatent(nn.Module):
    def __init__(self, d_model: int, z_g: int, z_l: int, dropout: float):
        super().__init__()
        self.z_g, self.z_l = z_g, z_l
        self.global_query = nn.Parameter(torch.zeros(1, 1, d_model))
        self.global_attention = MultiHeadDotProductAttention(d_model, 4, dropout)
        self.global_hidden = linear(d_model, 256)
        self.global_out = linear(256, 2 * z_g)
        self.local_hidden = linear(d_model, 256)
        self.local_out = linear(256, 2 * z_l)

    def forward(self, H: Tensor, mask: Tensor):
        q = self.global_query.expand(H.shape[0], 1, -1)
        pooled = self.global_attention(q, H, mask)[:, 0]
        mu_g, lv_g = torch.split(self.global_out(F.relu(self.global_hidden(pooled))),
                                 self.z_g, dim=-1)
        mu_l, lv_l = torch.split(self.local_out(F.relu(self.local_hidden(H))),
                                 self.z_l, dim=-1)
        return mu_g, lv_g, mu_l, lv_l


def reparam(mu: Tensor, lv: Tensor, generator=None, eps: Optional[Tensor] = None) -> Tensor:
    """z = mu + eps * exp(0.5 * clip(lv, +-10))."""
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
    return mu + eps * torch.exp(0.5 * torch.clamp(lv, -10.0, 10.0))


class ProteinEncoder(nn.Module):
    def __init__(self, seqemb_dim, d_model, nhead, ff, nlayers, z_g, z_l, dropout):
        super().__init__()
        self.enc = DihedralAwareEncoder(seqemb_dim, d_model, nhead, ff, nlayers, dropout)
        self.latent = HierLatent(d_model, z_g, z_l, dropout)

    def forward(self, seqemb, n_coords, ca_coords, c_coords, dihedrals, mask,
                generator=None, eps=None):
        H = self.enc(seqemb, n_coords, ca_coords, c_coords, dihedrals, mask)
        mu_g, lv_g, mu_l, lv_l = self.latent(H, mask)
        eps_g, eps_l = eps if eps is not None else (None, None)
        z_g = reparam(mu_g, lv_g, generator, eps_g)
        z_l = reparam(mu_l, lv_l, generator, eps_l)
        return z_g, z_l, mu_g, lv_g, mu_l, lv_l


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def band_indices(L: int, W: int, device=None) -> tuple[Tensor, Tensor]:
    """Neighbor indices [L, 2W+1] (clipped) and the in-range, non-self mask."""
    offs = torch.arange(2 * W + 1, device=device) - W
    base = torch.arange(L, device=device)[:, None] + offs[None, :]
    return base.clamp(0, L - 1), (base >= 0) & (base < L) & (offs != 0)[None, :]


def band_rows(a, bs, x, nbr_idx, valid, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
              lo: int, hi: int) -> tuple[Tensor, Tensor]:
    """The EGNN edge chain of receivers lo..hi-1 over their band: (summed
    messages [B, rows, H], raw coordinate update [B, rows, 3])."""
    idx = nbr_idx[lo:hi]
    mask_k = valid[:, lo:hi].to(a.dtype)[..., None]
    rel = x[:, lo:hi, None, :] - x[:, idx]
    d2 = torch.sum(rel * rel, dim=-1, keepdim=True)
    pre = a[:, lo:hi, None, :] + bs[:, idx] + d2 * w_d.reshape(-1)
    m = F.silu(F.silu(pre) @ w_e2 + b_e2.reshape(-1))
    agg = torch.sum(m * mask_k, dim=2)
    w = F.silu(m @ w_x1 + b_x1.reshape(-1)) @ w_x2.reshape(-1, 1) + b_x2.reshape(1)
    return agg, torch.sum(w * mask_k * rel, dim=2)


def band_chain(a, bs, x, nbr_idx, valid, *edge) -> tuple[Tensor, Tensor]:
    """``band_rows`` over all receivers, ``BAND_ROWS`` at a time, each block
    recomputed in the backward."""
    L = a.shape[1]
    parts = []
    for lo in range(0, L, BAND_ROWS):
        hi = min(L, lo + BAND_ROWS)
        if torch.is_grad_enabled():
            parts.append(checkpoint(band_rows, a, bs, x, nbr_idx, valid, *edge, lo, hi,
                                    use_reentrant=False))
        else:
            parts.append(band_rows(a, bs, x, nbr_idx, valid, *edge, lo, hi))
    return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)


def _param(shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


class EGNNBandLayer(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        Hd = hidden
        self.phi_e1_hi_kernel = _param((Hd, Hd))
        self.phi_e1_hi_bias = _param((Hd,))
        self.phi_e1_hj_kernel = _param((Hd, Hd))
        self.phi_e1_d2_kernel = _param((1, Hd))
        self.phi_e2_kernel = _param((Hd, Hd))
        self.phi_e2_bias = _param((Hd,))
        self.phi_x1_kernel = _param((Hd, Hd))
        self.phi_x1_bias = _param((Hd,))
        self.phi_x2_kernel = _param((Hd, 1))
        self.phi_x2_bias = _param((1,))
        self.phi_h1 = linear(2 * Hd, Hd)
        self.phi_h2 = linear(Hd, Hd)
        self.norm_h = layer_norm(Hd)

    def forward(self, h, x, nbr_idx, nbr_valid, deg_inv):
        a_i = h @ self.phi_e1_hi_kernel + self.phi_e1_hi_bias
        b_j = h @ self.phi_e1_hj_kernel
        agg, raw_delta = band_chain(a_i, b_j, x, nbr_idx, nbr_valid, self.phi_e1_d2_kernel,
                                    self.phi_e2_kernel, self.phi_e2_bias, self.phi_x1_kernel,
                                    self.phi_x1_bias, self.phi_x2_kernel, self.phi_x2_bias)
        hu = self.phi_h2(F.silu(self.phi_h1(torch.cat([h, agg], dim=-1))))
        return self.norm_h(h + hu), x + raw_delta * deg_inv[..., None] * 0.2


class EGNNDecoder(nn.Module):
    def __init__(self, z_g, z_l, hidden, num_layers, max_neighbors, dropout,
                 degree_normalize):
        super().__init__()
        self.num_layers, self.max_neighbors = num_layers, max_neighbors
        self.degree_normalize = degree_normalize
        zc = z_g + z_l
        self.l2c_dense1 = linear(zc, hidden)
        self.l2c_norm = layer_norm(hidden)
        self.l2c_dense2 = linear(hidden, hidden // 2)
        self.l2c_out = linear(hidden // 2, 3)
        self.input_embedding = linear(zc, hidden)
        for i in range(num_layers):
            self.add_module(f"egnn_{i}", EGNNBandLayer(hidden))
        self.seq_dense1 = linear(hidden, hidden * 2)
        self.seq_norm1 = layer_norm(hidden * 2)
        self.seq_dense2 = linear(hidden * 2, hidden)
        self.seq_norm2 = layer_norm(hidden)
        self.seq_out = linear(hidden, 20)
        self.n_off1 = linear(hidden, hidden // 2)
        self.n_off2 = linear(hidden // 2, 4)
        self.c_off1 = linear(hidden, hidden // 2)
        self.c_off2 = linear(hidden // 2, 4)
        self.drop = Dropout(dropout)
        self.drop_half = Dropout(dropout * 0.5)

    def forward(self, z_g: Tensor, z_l: Tensor, mask: Tensor):
        B, L, _ = z_l.shape
        mask = mask.to(torch.float32)
        pos, inv_pos, cmask = compact_valid(mask)
        zl_c = torch.gather(z_l, 1, pos[..., None].expand(-1, -1, z_l.shape[-1]))
        zc = torch.cat([z_g[:, None, :].expand(B, L, z_g.shape[-1]), zl_c], dim=-1)
        t = self.drop_half(F.relu(self.l2c_norm(self.l2c_dense1(zc))))
        x = self.l2c_out(F.relu(self.l2c_dense2(t)))
        h = self.input_embedding(zc)
        nbr_idx, in_range = band_indices(L, self.max_neighbors, z_l.device)
        cm = cmask > 0.5
        nbr_valid = in_range[None] & cm[:, :, None] & cm[:, nbr_idx]
        deg = nbr_valid.sum(-1).to(torch.float32)
        deg_inv = (1.0 / torch.clamp(deg, min=1.0) if self.degree_normalize
                   else torch.ones_like(deg))
        for i in range(self.num_layers):
            h, x = getattr(self, f"egnn_{i}")(h, x, nbr_idx, nbr_valid, deg_inv)
            h = self.drop(h)
        s = self.drop_half(F.relu(self.seq_norm1(self.seq_dense1(h))))
        s = self.drop_half(F.relu(self.seq_norm2(self.seq_dense2(s))))
        seq_logits = self.seq_out(s)
        n_head = self.n_off2(F.relu(self.n_off1(h)))
        c_head = self.c_off2(F.relu(self.c_off1(h)))
        x_n = x + safe_normalize(n_head[..., :3]) * BOND_N_CA
        x_c = x + safe_normalize(c_head[..., :3]) * BOND_CA_C
        if L > 1:
            for _ in range(3):
                vec = x_n[:, 1:] - x_c[:, :-1]
                dist = safe_norm(vec, keepdim=True)
                scale = torch.clamp(1.0 + 0.15 * (BOND_C_N / (dist + 1e-8) - 1.0), 0.90, 1.10)
                x_n = torch.cat([x_n[:, :1], x_c[:, :-1] + vec * scale], dim=1)
        return tuple(scatter_compact(v, inv_pos, mask) for v in (x_n, x, x_c, seq_logits))


class HierCVAE(nn.Module):
    """``forward`` -> (pred_N, pred_CA, pred_C, pred_seq, mu_g, lv_g, mu_l,
    lv_l). ``cfg`` is a dict of the port's ``ModelConfig`` fields."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.encoder = ProteinEncoder(cfg["seqemb_dim"], cfg["d_model"], cfg["nhead"],
                                      cfg["ff"], cfg["nlayers"], cfg["z_global"],
                                      cfg["z_local"], cfg["dropout"])
        self.decoder = EGNNDecoder(cfg["z_global"], cfg["z_local"], cfg["decoder_hidden"],
                                   cfg["decoder_layers"], cfg["max_neighbors"],
                                   cfg["dropout"], cfg["degree_normalize"])

    def forward(self, seqemb, n_coords, ca_coords, c_coords, dihedrals, mask,
                generator=None, eps=None):
        z_g, z_l, mu_g, lv_g, mu_l, lv_l = self.encoder(
            seqemb, n_coords, ca_coords, c_coords, dihedrals, mask, generator, eps)
        return (*self.decoder(z_g, z_l, mask), mu_g, lv_g, mu_l, lv_l)

    def encode(self, *args, generator=None, eps=None):
        return self.encoder(*args, generator=generator, eps=eps)

    def decode(self, z_g, z_l, mask):
        return self.decoder(z_g, z_l, mask)
