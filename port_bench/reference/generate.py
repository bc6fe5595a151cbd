"""One structure's generation, plain PyTorch: the port's
``infer/generate.py:generate_ensembles`` on the reference model and the
reference refiners (``refine.py``). Its random draws are the port's, draw
for draw, from a ``torch.Generator`` seeded with the call's seed: the
encoder's two reparameterisation draws, then the ensemble's global and
local noise.
"""

from __future__ import annotations

import torch

# the Cartesian stage of refine_mode "polish"
POLISH_CARTESIAN = dict(steps=600, lr=0.05, anchor_weight=0.003, w_bond=4.0,
                        w_rama=2.0, w_omega=2.0, w_clash=5.0, w_angle=8.0,
                        w_clash_vdw=400.0, lr_decay=True)


@torch.no_grad()
def decode(model, inputs: list, mask: torch.Tensor, *, num_samples: int, seed: int,
           temperature: float) -> tuple:
    """``inputs`` (seq_emb, n, ca, c, dihedrals) and ``mask`` padded to the
    structure's bucket, batch 1, on the device. Returns the reconstruction
    [L_pad, 3 (N, CA, C), 3] and the decoded ensemble [3, num_samples,
    L_pad, 3] (N, CA, C stacked first, as the refiners take it)."""
    model.eval()
    dev = mask.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    z_g, z_l, mu_g, lv_g, mu_l, lv_l = model.encode(*inputs, mask, generator=gen)
    rec = model.decode(z_g, z_l, mask)
    eps_g = torch.randn((num_samples,) + tuple(mu_g.shape[1:]), generator=gen, device=dev)
    eps_l = torch.randn((num_samples,) + tuple(mu_l.shape[1:]), generator=gen, device=dev)
    zs_g = mu_g + temperature * eps_g * torch.exp(0.5 * lv_g)
    zs_l = mu_l + temperature * eps_l * torch.exp(0.5 * lv_l)
    n, ca, c, _ = model.decode(zs_g, zs_l, mask.expand(num_samples, mask.shape[1]))
    return torch.stack(rec[:3], 2)[0], torch.stack([n, ca, c])



def torsion_kwargs(tr: dict) -> dict:
    """The torsion stage's arguments under ``refine_mode`` "polish", as
    ``generate_ensembles`` passes them from the traffic's flags (the vdW
    weight and the decay from ``refine_kwargs``, else the refiner's
    defaults)."""
    kw = dict(w_clash_vdw=25.0, lr_decay=True)
    kw.update({k: v for k, v in tr["refine_kwargs"].items() if k in kw})
    return dict(steps=tr["refine_steps"], lr=tr["refine_lr"], anchor_weight=tr["refine_anchor"],
                w_rama=tr["refine_w_rama"], w_omega=tr["refine_w_rama"] / 2.0,
                include_o=True, **kw)
