"""HierCVAE — the hierarchical conditional VAE (counterpart of the JAX
package's ``models/vae.py``).

``forward`` returns ``(pred_N, pred_CA, pred_C, pred_seq, mu_g, lv_g,
mu_l, lv_l)``. Random draws come from an explicit ``torch.Generator``;
``model.eval()`` turns dropout off (Flax's ``deterministic=True``);
``ModelConfig.decoder_remat`` recomputes each EGNN layer in the backward.
``dtype`` is the compute dtype, as the JAX ``HierCVAE(config, dtype)``:
fp32 or bf16, with fp32 parameters either way (``models/init.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from protein_ensemble_vae_torch.config import ModelConfig
from protein_ensemble_vae_torch.models.decoder import EGNNDecoder
from protein_ensemble_vae_torch.models.encoder import ProteinEncoder

Tensor = torch.Tensor


class HierCVAE(nn.Module):
    def __init__(self, config: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.encoder = ProteinEncoder(
            seqemb_dim=cfg.seqemb_dim, d_model=cfg.d_model, nhead=cfg.nhead,
            ff=cfg.ff, nlayers=cfg.nlayers, z_g=cfg.z_global, z_l=cfg.z_local,
            dropout=cfg.dropout, dtype=dtype)
        self.decoder = EGNNDecoder(
            z_g=cfg.z_global, z_l=cfg.z_local, hidden=cfg.decoder_hidden,
            num_layers=cfg.decoder_layers, max_neighbors=cfg.max_neighbors,
            dropout=cfg.dropout, degree_normalize=cfg.degree_normalize,
            remat=cfg.decoder_remat, use_pallas=cfg.use_pallas_egnn, dtype=dtype)

    def forward(self, seqemb: Tensor, n_coords: Tensor, ca_coords: Tensor,
                c_coords: Tensor, dihedrals: Tensor, mask: Tensor,
                generator: Optional[torch.Generator] = None,
                eps: Optional[tuple[Tensor, Tensor]] = None):
        z_g, z_l, mu_g, lv_g, mu_l, lv_l = self.encoder(
            seqemb, n_coords, ca_coords, c_coords, dihedrals, mask,
            generator=generator, eps=eps)
        pred_n, pred_ca, pred_c, pred_seq = self.decoder(z_g, z_l, mask=mask)
        return pred_n, pred_ca, pred_c, pred_seq, mu_g, lv_g, mu_l, lv_l

    def encode(self, seqemb: Tensor, n_coords: Tensor, ca_coords: Tensor,
               c_coords: Tensor, dihedrals: Tensor, mask: Tensor,
               generator: Optional[torch.Generator] = None,
               eps: Optional[tuple[Tensor, Tensor]] = None):
        return self.encoder(seqemb, n_coords, ca_coords, c_coords, dihedrals,
                            mask, generator=generator, eps=eps)

    def decode(self, z_g: Tensor, z_l: Tensor, mask: Optional[Tensor] = None):
        return self.decoder(z_g, z_l, mask=mask)

    def sample(self, mask: Tensor, num_samples: int = 1,
               generator: Optional[torch.Generator] = None):
        """Prior sampling: z ~ N(0, I), decoded for each of ``num_samples``
        draws per batch row."""
        cfg = self.config
        B, L = mask.shape
        z_g = torch.randn((B * num_samples, cfg.z_global), generator=generator,
                          device=mask.device)
        z_l = torch.randn((B * num_samples, L, cfg.z_local),
                          generator=generator, device=mask.device)
        mask_rep = torch.repeat_interleave(mask, num_samples, dim=0)
        return self.decoder(z_g, z_l, mask=mask_rep)
