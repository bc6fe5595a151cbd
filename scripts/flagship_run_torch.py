#!/usr/bin/env python3
"""Flagship annealed-KL run of the PyTorch port, on one card.

The port's counterpart of ``scripts/flagship_run.py``: the same stages,
environment knobs and flags, driving the port's CLIs
(``python -m protein_ensemble_vae_torch.cli.{train,generate,analyze}``)
with ``--device cuda``. It imports nothing of JAX.

- ``data``: the flagship synthetic dataset (7 proteins, 6 to train and 1
  to validate, K = 5 conformers, L 128 / 192, 1280-wide sequence
  embeddings, seed 0) as H5 files written by the port's own
  ``data.h5file`` (no h5py), with the arrays the JAX data stage writes.
- ``train``: the full ``ModelConfig()`` model in bf16 (fp32 parameters),
  B8, lr 5e-5, a monotonic KL warm-up held at its maximum for the rest of
  the run, no early stop, a checkpoint every 50 epochs, ``train_log.jsonl``.
- ``gen``: from ``ckpt/best``, two batteries of the validation protein's
  structures at 20 samples and temperature 0.7, each analyzed:
  raw (``--refine_steps 0``) into ``generated_raw/`` and
  ``analysis_raw.txt``; polish (``--refine_steps FLAGSHIP_REFINE
  --refine_mode polish``) into ``generated/`` and ``analysis.txt``.
- ``strict_ft``: the strict-geometry fine-tune of the annealed run
  (``configs/strict_finetune.json``) and its raw / refined batteries, into
  FLAGSHIP_STRICT_ROOT; not part of ``all``.

Every stage adds to ``run.json`` under FLAGSHIP_ROOT: its commands, its
wall seconds, the card's name and power limit (``nvidia-smi``), and after
training the epochs run and the seconds per epoch (``train_log.jsonl``).

Usage: python scripts/flagship_run_torch.py [data|train|gen|strict_ft|all]
Env: FLAGSHIP_ROOT (default runs/port_flagship), FLAGSHIP_EPOCHS (400),
     FLAGSHIP_WARMUP (120), FLAGSHIP_FOLD (compact|nerf|helix),
     FLAGSHIP_NOISE (for nerf the torsion-jitter scale * 0.3),
     FLAGSHIP_PLATEAU (--plateau_patience), FLAGSHIP_REFINE (150),
     FLAGSHIP_STRICT=1 (--strict_geometry), FLAGSHIP_STRICT_ROOT (default
     runs/port_flagship_strict_ft), as the JAX script; and
     FLAGSHIP_RESUME=1 (train with --resume, from ckpt/best),
     FLAGSHIP_SAMPLES (20), FLAGSHIP_DEVICE (cuda).

A time limit around the command (``timeout N python ...``) ends it with a
TERM: the stage under way is recorded in run.json as not ok, the command
exits non-zero, and the epochs so far stay in train_log.jsonl and
ckpt/best, from which FLAGSHIP_RESUME=1 goes on.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

PKG = "protein_ensemble_vae_torch"
ENV = dict(os.environ, PYTHONPATH=REPO + (
    os.pathsep + os.environ["PYTHONPATH"] if os.environ.get("PYTHONPATH") else ""))


def settings(env=None) -> dict:
    """The run's knobs from the environment (``env``, default os.environ)."""
    env = os.environ if env is None else env
    fold = env.get("FLAGSHIP_FOLD", "compact")
    root = env.get("FLAGSHIP_ROOT", os.path.join(REPO, "runs", "port_flagship"))
    return dict(
        root=os.path.abspath(root),
        epochs=int(env.get("FLAGSHIP_EPOCHS", "400")),
        warmup=int(env.get("FLAGSHIP_WARMUP", "120")),
        fold=fold,
        # nerf folds take torsion jitter, not A of coordinate noise
        noise=float(env.get("FLAGSHIP_NOISE", "0.105" if fold == "nerf" else "0.3")),
        plateau=env.get("FLAGSHIP_PLATEAU") or None,
        refine=env.get("FLAGSHIP_REFINE", "150"),
        samples=env.get("FLAGSHIP_SAMPLES", "20"),
        strict=env.get("FLAGSHIP_STRICT") == "1",
        strict_root=os.path.abspath(env.get(
            "FLAGSHIP_STRICT_ROOT", os.path.join(REPO, "runs", "port_flagship_strict_ft"))),
        resume=env.get("FLAGSHIP_RESUME") == "1",
        device=env.get("FLAGSHIP_DEVICE", "cuda"),
    )


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not measured ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else "not measured (nvidia-smi failed)"


def _record(root: str, entry: dict) -> None:
    """Append a stage's entry to ``root/run.json`` and refresh its summary."""
    path = os.path.join(root, "run.json")
    run = {"stages": []}
    if os.path.exists(path):
        with open(path) as f:
            run = json.load(f)
    run["stages"].append(entry)
    log = os.path.join(root, "train_log.jsonl")
    if os.path.exists(log):
        recs = [json.loads(line) for line in open(log) if line.strip()]
        secs = [r["seconds"] for r in recs if "seconds" in r]
        run["epochs_logged"] = len(recs)
        run["last_epoch"] = recs[-1]["epoch"] if recs else 0
        if secs:
            run["median_epoch_s"] = statistics.median(secs)
            run["median_epoch_s_after_first"] = (statistics.median(secs[1:])
                                                 if len(secs) > 1 else None)
            run["first_epoch_s"] = secs[0]
        rmsd = [(r["val/rmsd"], r["epoch"]) for r in recs if "val/rmsd" in r]
        if rmsd:
            run["best_val_rmsd"], run["best_val_rmsd_epoch"] = min(rmsd)
        run["nonfinite_epochs"] = sum(1 for r in recs if r.get("train/nonfinite_frac", 0))
    os.makedirs(root, exist_ok=True)
    with open(path, "w") as f:
        json.dump(run, f, indent=1)


def _run(cmds: list, log: list) -> None:
    for cmd in cmds:
        print("[flagship]", " ".join(cmd), flush=True)
        log.append(cmd)
        subprocess.run(cmd, check=True, env=ENV, cwd=REPO)


def _stage(name: str, root: str, body, **extra) -> None:
    """Run ``body(commands)`` and record the stage in run.json."""
    cmds: list = []
    t0 = time.time()
    ok = False
    try:
        body(cmds)
        ok = True
    finally:
        _record(root, dict(stage=name, commands=cmds, seconds=time.time() - t0, ok=ok,
                           card=card(), finished=time.strftime("%Y-%m-%dT%H:%M:%S"),
                           **extra))


def build_data(s: dict, lengths=(128, 192), seqemb_dim: int = 1280) -> tuple[str, str]:
    """The flagship dataset under ``root/data`` (the JAX data stage's call,
    through the port's ``make_synthetic_dataset``)."""
    from protein_ensemble_vae_torch.data.synthetic import make_synthetic_dataset

    out = {}

    def body(cmds):
        call = (f"make_synthetic_dataset({os.path.join(s['root'], 'data')!r}, n_proteins=7, "
                f"K=5, lengths={tuple(lengths)}, seqemb_dim={seqemb_dim}, seed=0, "
                f"fold={s['fold']!r}, noise={s['noise']})")
        cmds.append([call])
        out["csv"] = make_synthetic_dataset(
            os.path.join(s["root"], "data"), n_proteins=7, K=5, lengths=tuple(lengths),
            seqemb_dim=seqemb_dim, seed=0, fold=s["fold"], noise=s["noise"])
        print(f"[flagship] data at {s['root']}/data (fold={s['fold']}, noise={s['noise']})")

    _stage("data", s["root"], body)
    return out["csv"]


def train_command(s: dict, extra: tuple = ()) -> list:
    root = s["root"]
    cmd = [sys.executable, "-m", f"{PKG}.cli.train",
           "--manifest_train", os.path.join(root, "data", "manifest_train.csv"),
           "--manifest_val", os.path.join(root, "data", "manifest_val.csv"),
           "--use_seqemb", "--batch_size", "8", "--lr", "5e-5",
           "--epochs", str(s["epochs"]), "--compute_dtype", "bfloat16",
           "--kl_schedule", "monotonic", "--kl_warmup_epochs", str(s["warmup"]),
           "--early_stopping_patience", str(s["epochs"]),  # run the full anneal
           "--checkpoint_every", "50",
           "--save", os.path.join(root, "ckpt"),
           "--log_jsonl", os.path.join(root, "train_log.jsonl"),
           "--device", s["device"]]
    if s["plateau"]:
        cmd += ["--plateau_patience", s["plateau"]]
    if s["strict"]:
        cmd.append("--strict_geometry")
    if s["resume"]:
        cmd.append("--resume")
    return cmd + list(extra)


def train(s: dict, extra: tuple = ()) -> None:
    _stage("train", s["root"], lambda cmds: _run([train_command(s, extra)], cmds),
           resume=s["resume"])


def battery_commands(s: dict, ckpt: str, root: str, tag: str, steps: str) -> list:
    """generate + analyze of one battery: ``generated{_tag}/``, ``analysis{_tag}.txt``."""
    suffix = f"_{tag}" if tag else ""
    outdir = os.path.join(root, f"generated{suffix}")
    gen = [sys.executable, "-m", f"{PKG}.cli.generate",
           "--checkpoint", ckpt, "--manifest", os.path.join(s["root"], "data", "manifest_val.csv"),
           "--num_samples", s["samples"], "--temperature", "0.7",
           "--refine_steps", steps, "--output_dir", outdir, "--device", s["device"]]
    if steps != "0":
        gen += ["--refine_mode", "polish"]
    return [gen, [sys.executable, "-m", f"{PKG}.cli.analyze", "--pdb_dir", outdir,
                  "--output", os.path.join(root, f"analysis{suffix}.txt"),
                  "--device", s["device"]]]


def _fresh(root: str, tag: str) -> None:
    """Clear a battery's earlier PDBs (the analysis reads every PDB there)."""
    shutil.rmtree(os.path.join(root, f"generated{'_' + tag if tag else ''}"),
                  ignore_errors=True)


def generate_and_analyze(s: dict) -> None:
    ckpt = os.path.join(s["root"], "ckpt", "best")

    def body(cmds):
        for tag, steps in (("raw", "0"), ("", s["refine"])):
            _fresh(s["root"], tag)
            _run(battery_commands(s, ckpt, s["root"], tag, steps), cmds)

    _stage("gen", s["root"], body)


def strict_ft(s: dict) -> None:
    """Strict-geometry fine-tune from the annealed best checkpoint, then its
    raw / refined batteries, into FLAGSHIP_STRICT_ROOT."""
    root, sroot = s["root"], s["strict_root"]
    cmd = [sys.executable, "-m", f"{PKG}.cli.train",
           "--manifest_train", os.path.join(root, "data", "manifest_train.csv"),
           "--manifest_val", os.path.join(root, "data", "manifest_val.csv"),
           "--config", os.path.join(REPO, "configs", "strict_finetune.json"),
           "--use_seqemb", "--compute_dtype", "bfloat16",
           "--init_from", os.path.join(root, "ckpt", "best"),
           "--checkpoint_every", "0",
           "--save", os.path.join(sroot, "ckpt"),
           "--log_jsonl", os.path.join(sroot, "train_log.jsonl"),
           "--device", s["device"]]

    def body(cmds):
        _run([cmd], cmds)
        for tag, steps in (("raw", "0"), ("refined", s["refine"])):
            _fresh(sroot, tag)
            _run(battery_commands(s, os.path.join(sroot, "ckpt", "best"), sroot, tag, steps),
                 cmds)

    _stage("strict_ft", sroot, body)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "all"
    if mode not in ("data", "train", "gen", "all", "strict_ft"):
        raise SystemExit(f"unknown stage {mode!r} (data|train|gen|strict_ft|all)")
    s = settings()
    # a TERM (a time limit around the command) ends the stage through its
    # `finally`, which records it in run.json
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    if mode in ("data", "all"):
        build_data(s)
    if mode in ("train", "all"):
        train(s)
    if mode in ("gen", "all"):
        generate_and_analyze(s)
    if mode == "strict_ft":
        strict_ft(s)


if __name__ == "__main__":
    main()
