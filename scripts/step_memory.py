"""Where a train step's device memory goes, fp32 against bf16
(``HierCVAE(dtype=...)``), on one NVIDIA GPU, at the default widths.

    python scripts/step_memory.py [--out FILE.json]

For each dtype and for the kernel path (``use_pallas_egnn="auto"``) and the
plain path (``False``) at chip_smoke.py's timed-step shapes (B4/L256, and
B2/L640 with ``decoder_remat``), after two warm-up steps of
``make_train_step``: the bytes the forward saves for the backward (every
tensor autograd saves, counted once per storage, by dtype; the model's own
parameters apart), the device memory allocated when the forward ends, the
peak allocated over the forward and over the backward, and the peak over
one whole train step (forward, backward, optimizer), each above what was
allocated before (model, optimizer state, batch). Prints one JSON line;
needs a GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

MIB = 2 ** 20


def measure(dtype, spec: dict, use_pallas) -> dict:
    import torch

    from protein_ensemble_vae_torch.config import LossWeights, ModelConfig
    from protein_ensemble_vae_torch.models import HierCVAE
    from protein_ensemble_vae_torch.train.training import (TrainState, make_loss_fn,
                                                           make_train_step)

    cfg = ModelConfig(decoder_remat=spec["remat"], use_pallas_egnn=use_pallas)
    torch.manual_seed(cs.SEED)
    model = HierCVAE(cfg, dtype=dtype).to(cs.DEVICE)
    batch = cs._step_batch(spec["B"], spec["L"], spec["L_real"], cs.SEED + 8, cfg.seqemb_dim)
    consts = [torch.tensor(v, device=cs.DEVICE) for v in (0.5, 0.25, 3e-5)]
    state = TrainState.create(model)
    step = make_train_step(model, LossWeights(), train=True)
    for i in range(2):
        step(state, batch, i, *consts)
    loss_fn = make_loss_fn(model, LossWeights())
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    saved: dict = {}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in params and ptr not in saved:
            saved[ptr] = (str(t.dtype).replace("torch.", ""), t.untyped_storage().nbytes())
        return t

    model.train()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        total, _ = loss_fn(batch, *consts[:2])
    torch.cuda.synchronize()
    after_fwd = torch.cuda.memory_allocated() - base
    peak_fwd = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    total.backward()
    torch.cuda.synchronize()
    peak_bwd = torch.cuda.max_memory_allocated() - base
    for p in state.params:
        p.grad = None
    torch.cuda.synchronize()
    base_step = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(state, batch, 2, *consts)
    torch.cuda.synchronize()
    peak_step = torch.cuda.max_memory_allocated() - base_step
    by_dtype: dict = {}
    for d, n in saved.values():
        by_dtype[d] = by_dtype.get(d, 0.0) + n / MIB
    out = dict(saved_mib=sum(by_dtype.values()), saved_by_dtype_mib=by_dtype,
               after_forward_mib=after_fwd / MIB, peak_forward_mib=peak_fwd / MIB,
               peak_backward_mib=peak_bwd / MIB, peak_step_mib=peak_step / MIB,
               base_mib=base / MIB)
    del model, state, step, batch, total
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    device = cs.phase_device()
    cs.phase_build()
    from protein_ensemble_vae_torch.ops.routing import set_full_fp32

    set_full_fp32()
    rows = []
    for spec in cs.TIMED_STEPS:
        tag = f"B{spec['B']}/L{spec['L']}" + ("+remat" if spec["remat"] else "")
        for dtype in (torch.float32, torch.bfloat16):
            for path, use in (("kernel", "auto"), ("plain", False)):
                r = dict(shape=tag, dtype=str(dtype).replace("torch.", ""), path=path,
                         **measure(dtype, spec, use))
                cs.log(f"[memory] {tag} {r['dtype']} {path}: saved {r['saved_mib']:.1f} MiB "
                       f"({', '.join(f'{k} {v:.1f}' for k, v in r['saved_by_dtype_mib'].items())}), "
                       f"allocated after the forward {r['after_forward_mib']:.1f} MiB, peak "
                       f"forward {r['peak_forward_mib']:.1f} / backward "
                       f"{r['peak_backward_mib']:.1f} MiB, whole step "
                       f"{r['peak_step_mib']:.1f} MiB, above the {r['base_mib']:.1f} MiB "
                       f"before the step")
                rows.append(r)
    line = json.dumps({"device": device["smi"], "step_memory": rows})
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
