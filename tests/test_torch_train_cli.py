"""The port's train CLI (``protein_ensemble_vae_torch.cli.train``, the
``pev-train`` counterpart) end to end on the CPU at tiny widths: the
checkpoint file set, the history's metric names (the JAX package's
``EPOCH_METRICS``), ``--resume``, the generation CLI on the trained
checkpoint, the bf16 compute path (``--compute_dtype bfloat16``) trained
and generated from, ``--dp`` / ``--tp`` / ``--multihost`` and
``--watch_every``."""

import json
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from protein_ensemble_vae_torch.cli import generate as gen_cli  # noqa: E402
from protein_ensemble_vae_torch.cli import train as train_cli  # noqa: E402
from protein_ensemble_vae_torch.data import make_synthetic_dataset  # noqa: E402
from protein_ensemble_vae_tpu.config import RunConfig as JRunConfig  # noqa: E402
from protein_ensemble_vae_tpu.train.training import EPOCH_METRICS  # noqa: E402

TINY = ["--use_seqemb", "--batch_size", "4", "--lr", "1e-4", "--d_model", "32",
        "--nhead", "4", "--ff", "64", "--nlayers", "1", "--z_global", "16",
        "--z_local", "8", "--decoder_hidden", "16", "--decoder_layers", "2",
        "--max_neighbors", "4"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    tr, va = make_synthetic_dataset(str(root / "data"), n_proteins=2, K=3,
                                    lengths=(24,), seqemb_dim=16, seed=7)
    base = ["--manifest_train", tr, "--manifest_val", va, *TINY,
            "--save", str(root / "ckpt"), "--device", "cpu"]
    train_cli.main(base + ["--epochs", "2"])
    return root, base


def test_writes_checkpoint_with_jax_metric_names(run):
    root, _ = run
    final = root / "ckpt" / "final"
    assert sorted(os.listdir(final)) == ["history.json", "meta.json", "state.pt"]
    hist = json.loads((final / "history.json").read_text())
    for split in ("train", "val"):
        assert set(hist[split]) == set(EPOCH_METRICS)
        for k, vals in hist[split].items():
            assert len(vals) == 2 and np.isfinite(vals).all(), (split, k)
    meta = json.loads((final / "meta.json").read_text())
    assert meta["epoch"] == 2
    # the config block is the JAX sidecar's contract
    jcfg = JRunConfig.from_json(json.dumps(meta["config"]))
    assert json.loads(jcfg.to_json()) == meta["config"]
    state = torch.load(final / "state.pt", weights_only=True)
    assert state["train"]["step"] > 0 and int(state["train"]["count"]) > 0
    assert (root / "ckpt" / "artifacts.jsonl").exists()


def test_resume_continues_at_next_epoch(run, capsys):
    root, base = run
    best = json.loads((root / "ckpt" / "best" / "meta.json").read_text())
    capsys.readouterr()
    train_cli.main(base + ["--epochs", str(best["epoch"] + 1), "--resume"])
    out = capsys.readouterr().out
    assert f"at epoch {best['epoch'] + 1}" in out
    assert f"[epoch {best['epoch'] + 1:4d}]" in out
    assert "[epoch    1]" not in out


def test_generate_loads_trained_checkpoint(run):
    root, base = run
    va = base[base.index("--manifest_val") + 1]
    out_dir = root / "generated"
    gen_cli.main(["--checkpoint", str(root / "ckpt" / "final"), "--manifest", va,
                  "--output_dir", str(out_dir), "--num_samples", "3",
                  "--max_structures", "1", "--device", "cpu"])
    pdbs = sorted(p for p in os.listdir(out_dir) if p.endswith(".pdb"))
    assert len(pdbs) == 3 and any(p.endswith("_ensemble.pdb") for p in pdbs)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("extra", [["--dp", "2"], ["--tp", "2"], ["--multihost"],
                                   ["--watch_every", "1"]])
def test_parallel_and_watch_flags_train_an_epoch(run, tmp_path, extra):
    """``--dp``, ``--tp``, ``--multihost`` (one process here, its own
    coordinator) and ``--watch_every`` each train one epoch and write the
    full model's checkpoint, as the single-process run's, and leave no
    process group behind; ``--watch_every 1`` also writes that epoch's
    param / grad histograms."""
    root, base = run
    if extra == ["--multihost"]:
        # a multi-host rank drops every partial batch: 3 val pairs need batch 2
        extra = extra + ["--batch_size", "2", "--num_processes", "1", "--process_id", "0",
                         "--coordinator_address", f"localhost:{_free_port()}"]
    save = tmp_path / "ckpt"
    train_cli.main(base + ["--epochs", "1"] + extra + ["--save", str(save)])
    assert not torch.distributed.is_initialized()
    got = torch.load(save / "final" / "state.pt", weights_only=True)
    want = torch.load(root / "ckpt" / "final" / "state.pt", weights_only=True)
    assert {k: v.shape for k, v in got["model"].items()} == \
        {k: v.shape for k, v in want["model"].items()}
    with open(save / "final" / "history.json") as f:
        hist = json.load(f)
    assert len(hist["train"]["loss"]) == 1 and np.isfinite(hist["val"]["loss"]).all()
    watched = extra == ["--watch_every", "1"]
    assert os.path.isdir(save / "watch") == watched
    if watched:
        assert os.listdir(save / "watch") == ["epoch_00001.npz"]
        z = np.load(save / "watch" / "epoch_00001.npz")
        for k in got["model"]:
            assert f"param/{k}/counts" in z.files and f"grad/{k}/l2" in z.files, k


def test_bf16_compute_path_trains_and_generates(run, monkeypatch):
    """``--compute_dtype bfloat16``: the model computes in bf16 with fp32
    parameters; 2 epochs with finite losses and a checkpoint that records
    the dtype; ``cli.generate`` builds an fp32 model from it, as the JAX
    side's generation does (it takes no dtype)."""
    import protein_ensemble_vae_torch.models as models

    root, base = run
    save = root / "ckpt_bf16"
    argv = [a for a in base if a != str(root / "ckpt")]
    argv[argv.index("--save") + 1:argv.index("--save") + 1] = [str(save)]
    built = []
    orig = models.HierCVAE

    def record(cfg, *a, **kw):
        built.append(orig(cfg, *a, **kw))
        return built[-1]

    monkeypatch.setattr(models, "HierCVAE", record)
    train_cli.main(argv + ["--epochs", "2", "--compute_dtype", "bfloat16"])
    assert built[0].dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in built[0].parameters())
    final = save / "final"
    hist = json.loads((final / "history.json").read_text())
    for split in ("train", "val"):
        for k, vals in hist[split].items():
            assert len(vals) == 2 and np.isfinite(vals).all(), (split, k)
    meta = json.loads((final / "meta.json").read_text())
    assert meta["config"]["train"]["compute_dtype"] == "bfloat16"
    state = torch.load(final / "state.pt", weights_only=True)
    assert all(v.dtype == torch.float32 for v in state["model"].values()
               if v.is_floating_point())

    va = base[base.index("--manifest_val") + 1]
    out_dir = root / "generated_bf16"
    gen_cli.main(["--checkpoint", str(final), "--manifest", va, "--output_dir",
                  str(out_dir), "--num_samples", "3", "--max_structures", "1",
                  "--device", "cpu"])
    assert built[-1].dtype == torch.float32
    pdbs = sorted(p for p in os.listdir(out_dir) if p.endswith(".pdb"))
    assert len(pdbs) == 3 and any(p.endswith("_ensemble.pdb") for p in pdbs)


def test_default_device_without_gpu_raises(run, monkeypatch):
    _, base = run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in base if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(argv + ["--epochs", "1"])
