"""Variants of the torsion refiner's NeRF rebuild (``infer/torsion_refine.py``,
a prefix product of rigid transforms) on one NVIDIA GPU, in one process:
the transforms composed and the bond vectors summed in float64 or float32,
and the batched 3x3 products taken by ``torch.matmul`` (batched GEMMs) or
as elementwise multiply-adds.

    python scripts/nerf_rebuild_ab.py [--B 10] [--L 640] [--out FILE.json]
    python scripts/nerf_rebuild_ab.py --device cpu --B 2 --L 64   # errors only

For each variant, on the torsions (fp32, as the refiner holds them) and
seed of ``B`` NeRF conformers of one fold of length ``L``:
- the largest coordinate error against the sequential build in float64
  (``nerf_rebuild_reference``), and the largest N-CA / CA-C / C-N bond
  error against ``config.BOND_*``;
- device us of the rebuild's forward and gradient (``torch.autograd.grad``
  over the torsions), captured in a CUDA graph and replayed (chip_smoke.py's
  ``_graph_us``);
- device ms per Adam step of the polish torsion stage (chip_smoke.py's
  ``REFINE`` settings, the vdW term with O) with this rebuild: CUDA events
  around one ``refine_torsions`` call of ``--steps`` steps replayed from its
  CUDA graph (captured by a first call), over the steps.
Variants run in turns, forward then reverse order; each time is the mean
of the two turns, both given. ``module`` is ``nerf_rebuild`` as the package
has it. On the CPU only the errors are computed. Imports no JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def rebuild(phi, psi, omega, n0, ca0, c0, *, dtype, mm):
    """``nerf_rebuild`` with the composition dtype and the 3x3 product
    given."""
    import torch

    from protein_ensemble_vae_torch.infer import torsion_refine as T

    B, Ln = phi.shape
    out_dtype = phi.dtype
    n0, ca0, c0 = (t.to(dtype) for t in (n0, ca0, c0))
    rot, vec = T._local_frames(T._chain_torsions(phi, psi, omega).to(dtype))
    N, d = rot.shape[1], 1
    prefix = rot
    while d < N:
        prefix = torch.cat([prefix[:, :d], mm(prefix[:, :-d], prefix[:, d:])], dim=1)
        d *= 2
    local = torch.cat([vec[:, :1], mm(prefix[:, :-1], vec[:, 1:, :, None])[..., 0]], 1)
    bc = T._unit(c0 - ca0)
    nrm = T._unit(torch.cross(ca0 - n0, bc, dim=-1))
    seed = torch.stack([bc, torch.cross(nrm, bc, dim=-1), nrm], dim=-1)
    bonds = mm(seed[:, None], local[..., None])[..., 0]
    rest = c0[:, None] + torch.cumsum(bonds, dim=1)
    atoms = torch.cat([torch.stack([n0, ca0, c0], 1), rest], dim=1)
    return atoms.reshape(B, Ln, 3, 3).to(out_dtype).unbind(2)


def variants() -> dict:
    import torch

    from protein_ensemble_vae_torch.infer import torsion_refine as T

    out = {"module": T.nerf_rebuild}
    for dname, dt in (("f64", torch.float64), ("f32", torch.float32)):
        for pname, mm in (("matmul", torch.matmul), ("elementwise", T._mat3)):
            out[f"{dname}_{pname}"] = functools.partial(rebuild, dtype=dt, mm=mm)
    return out


def _errors(build, tors, seed, want) -> dict:
    import torch

    from protein_ensemble_vae_torch.config import BOND_C_N, BOND_CA_C, BOND_N_CA

    with torch.no_grad():
        got = [t.double() for t in build(*tors, *seed)]
    n, ca, c = got
    bonds = max(float(((ca - n).norm(dim=-1) - BOND_N_CA).abs().max()),
                float(((c - ca).norm(dim=-1) - BOND_CA_C).abs().max()),
                float(((n[:, 1:] - c[:, :-1]).norm(dim=-1) - BOND_C_N).abs().max()))
    return dict(max_abs_err=max(float((g - w).abs().max()) for g, w in zip(got, want)),
                bond_err=bonds)


def _step_ms(build, n, ca, c, mask, steps: int) -> float:
    """Device ms per Adam step of the polish torsion stage with ``build``."""
    import torch

    from protein_ensemble_vae_torch.infer import refine as R
    from protein_ensemble_vae_torch.infer import torsion_refine as T

    orig = T.nerf_rebuild
    T.nerf_rebuild = build
    try:
        R.clear_graphs()
        kw = dict(cs._torsion_stage_kwargs(), steps=steps)
        T.refine_torsions(n, ca, c, mask, **kw)            # captures the step
        torch.cuda.synchronize()
        return cs._window_ms(lambda: T.refine_torsions(n, ca, c, mask, **kw), 1) / steps
    finally:
        T.nerf_rebuild = orig
        R.clear_graphs()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--B", type=int, default=cs.NUM_SAMPLES)
    ap.add_argument("--L", type=int, default=640)
    ap.add_argument("--steps", type=int, default=20, help="Adam steps of a timed call")
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    args = ap.parse_args(argv)

    import torch

    from protein_ensemble_vae_torch.data.synthetic import nerf_ensemble
    from protein_ensemble_vae_torch.infer import torsion_refine as T

    dev = torch.device(args.device)
    timed = dev.type == "cuda"
    card = None
    if timed:
        if not torch.cuda.is_available():
            raise SystemExit("nerf_rebuild_ab: no CUDA device (use --device cpu for errors only)")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
        cs.log(card)
    n, ca, c = (torch.from_numpy(v).float().to(dev).contiguous() for v in
                nerf_ensemble(args.L, args.B, seed=cs.SEED + 20, max_tries=16))
    mask = torch.ones(args.B, args.L, device=dev)
    tors = T.torsions_from_coords(n, ca, c, mask)
    seed = T.ideal_seed_frame(n[:, 0], ca[:, 0], c[:, 0])
    want = T.nerf_rebuild_reference(*(t.double() for t in tors + seed))

    builds = variants()
    rows = {name: dict(name=name, **_errors(b, tors, seed, want)) for name, b in builds.items()}
    if timed:
        xs = [t.detach().clone().requires_grad_(True) for t in tors]
        wts = [torch.randn(args.B, args.L, 3, device=dev) for _ in range(3)]
        order = list(builds)
        for turn, names in enumerate((order, order[::-1])):
            for name in names:
                b = builds[name]

                def fwd_grad():
                    out = b(*xs, *seed)
                    loss = sum((o * w).sum() for o, w in zip(out, wts))
                    return torch.autograd.grad(loss, xs)

                rows[name].setdefault("rebuild_us", []).append(cs._graph_us(fwd_grad, n=10))
                rows[name].setdefault("step_ms", []).append(
                    _step_ms(b, n, ca, c, mask, args.steps))
        for r in rows.values():
            r["rebuild_us_mean"] = sum(r["rebuild_us"]) / 2
            r["step_ms_mean"] = sum(r["step_ms"]) / 2
    for r in rows.values():
        times = ("not measured (CPU)" if not timed else
                 f"rebuild fwd + grad {r['rebuild_us_mean']:.1f} us (turns "
                 f"{r['rebuild_us'][0]:.1f}, {r['rebuild_us'][1]:.1f}), torsion step "
                 f"{r['step_ms_mean']:.3f} ms (turns {r['step_ms'][0]:.3f}, "
                 f"{r['step_ms'][1]:.3f})")
        cs.log(f"[nerf] {r['name']:>16} B{args.B}/L{args.L}: max abs err vs float64 "
               f"sequential {r['max_abs_err']:.3e} A, bond err {r['bond_err']:.3e} A; {times}")
    result = dict(card=card, B=args.B, L=args.L, steps=args.steps, torch=torch.__version__,
                  rows=list(rows.values()))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
