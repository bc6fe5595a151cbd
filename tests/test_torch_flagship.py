"""The port's flagship pipeline (``scripts/flagship_run_torch.py``) against
the JAX package's (``scripts/flagship_run.py``), on the CPU.

- The data stage writes, through the port's own H5 writer, the arrays the
  JAX data stage writes from the same seed, at reduced L.
- Its train and generate commands carry the JAX script's flags, aimed at
  the port's CLIs on ``--device``.
- A tiny run goes data -> train -> both batteries -> analysis and records
  every stage in run.json.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return _load("flagship_run_torch", "scripts/flagship_run_torch.py")


@pytest.fixture(scope="module")
def jax_script():
    return _load("flagship_run_jax", "scripts/flagship_run.py")


def _settings(port, root, **env):
    return port.settings(dict({"FLAGSHIP_ROOT": str(root), "FLAGSHIP_FOLD": "nerf",
                               "FLAGSHIP_PLATEAU": "160", "FLAGSHIP_DEVICE": "cpu"}, **env))


def test_data_stage_writes_the_jax_arrays(port, tmp_path):
    """The JAX data stage's call (7 proteins, K 5, seed 0, nerf folds with
    noise 0.105, 1280-wide embeddings) at L 24 / 32 instead of 128 / 192:
    the same files, manifests and arrays; the torsions, computed by each
    package's own geometry, to atol 1e-5 (as
    test_torch_generate.py::test_synthetic_dihedrals_match_jax), the rest
    bitwise."""
    from protein_ensemble_vae_tpu.data.synthetic import make_synthetic_dataset

    s = _settings(port, tmp_path / "port")
    port.build_data(s, lengths=(24, 32))
    make_synthetic_dataset(str(tmp_path / "jax" / "data"), n_proteins=7, K=5,
                           lengths=(24, 32), seqemb_dim=1280, seed=0, fold="nerf",
                           noise=0.105)
    pdir, jdir = tmp_path / "port" / "data", tmp_path / "jax" / "data"
    files = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == files and len(files) == 9
    for name in files:
        if name.endswith(".csv"):
            strip = lambda p: [os.path.basename(x) for x in p.read_text().split()]  # noqa: E731
            assert strip(pdir / name) == strip(jdir / name)
            continue
        with h5py.File(pdir / name, "r") as p, h5py.File(jdir / name, "r") as j:
            keys = []
            j.visit(keys.append)
            got = []
            p.visit(got.append)
            assert sorted(got) == sorted(keys), name
            for k in keys:
                if not isinstance(j[k], h5py.Dataset):
                    continue
                a, b = p[k][()], j[k][()]
                assert type(a) is type(b), (name, k)
                if k.startswith("torsion_"):
                    np.testing.assert_allclose(a, b, atol=1e-5, err_msg=f"{name}:{k}")
                else:
                    assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), (name, k)
    run = json.loads((tmp_path / "port" / "run.json").read_text())
    assert [st["stage"] for st in run["stages"]] == ["data"] and run["stages"][0]["ok"]


def _jax_commands(jax_script, root, monkeypatch):
    """The JAX script's train and gen commands, recorded instead of run."""
    calls = []
    monkeypatch.setattr(jax_script, "ROOT", str(root))
    monkeypatch.setattr(jax_script.subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd))
    monkeypatch.setenv("FLAGSHIP_PLATEAU", "160")
    jax_script.train()
    jax_script.generate_and_analyze()
    return calls


def _flags(cmd):
    """module, {flag: value} of a ``python -m module --flag value ...`` command."""
    module, rest = cmd[2], cmd[3:]
    out, k = {}, 0
    while k < len(rest):
        if k + 1 < len(rest) and not rest[k + 1].startswith("--"):
            out[rest[k]] = rest[k + 1]
            k += 2
        else:
            out[rest[k]] = True
            k += 1
    return module, out


def test_commands_carry_the_jax_flags(port, jax_script, tmp_path, monkeypatch):
    root = tmp_path / "run"
    jtrain, jgen, janalyze = _jax_commands(jax_script, root, monkeypatch)
    s = _settings(port, root)
    module, flags = _flags(port.train_command(s))
    jmodule, jflags = _flags(jtrain)
    assert module == jmodule.replace("protein_ensemble_vae_tpu", "protein_ensemble_vae_torch")
    assert flags == dict(jflags, **{"--device": "cpu"})
    assert flags["--plateau_patience"] == "160" and flags["--epochs"] == "400"
    assert port.train_command(_settings(port, root, FLAGSHIP_RESUME="1"))[-1] == "--resume"
    ckpt = str(root / "ckpt" / "best")
    raw, refined = (port.battery_commands(s, ckpt, str(root), tag, steps)
                    for tag, steps in (("raw", "0"), ("", "150")))
    for (gen, analyze), refine_flags in ((raw, {"--refine_steps": "0"}),
                                         (refined, {"--refine_mode": "polish"})):
        module, flags = _flags(gen)
        _, jflags = _flags(jgen)
        assert module == "protein_ensemble_vae_torch.cli.generate"
        want = dict(jflags, **{"--device": "cpu"}, **refine_flags)
        want["--output_dir"] = flags["--output_dir"]
        assert flags == want
        _, aflags = _flags(analyze)
        assert aflags["--pdb_dir"] == flags["--output_dir"]
    assert _flags(refined[0])[1]["--output_dir"] == _flags(jgen)[1]["--output_dir"]
    assert _flags(refined[1])[1]["--output"] == _flags(janalyze)[1]["--output"]
    assert _flags(raw[0])[1]["--output_dir"].endswith("generated_raw")
    assert _flags(raw[1])[1]["--output"].endswith("analysis_raw.txt")


def test_tiny_run_end_to_end(port, tmp_path):
    """data -> train (1 epoch, tiny widths) -> raw and polish batteries (2
    samples, 2 refine steps) on the CPU: the files the flagship commits,
    and run.json's stages and summary."""
    root = tmp_path / "run"
    s = _settings(port, root, FLAGSHIP_EPOCHS="1", FLAGSHIP_SAMPLES="2", FLAGSHIP_REFINE="2")
    port.build_data(s, lengths=(24,), seqemb_dim=16)
    port.train(s, extra=("--d_model", "32", "--nhead", "4", "--ff", "64", "--nlayers", "1",
                         "--z_global", "16", "--z_local", "8", "--decoder_hidden", "16",
                         "--decoder_layers", "2", "--max_neighbors", "4"))
    port.generate_and_analyze(s)
    for f in ("train_log.jsonl", "analysis.txt", "analysis_raw.txt",
              "generated/generation_summary.txt", "generated_raw/generation_summary.txt"):
        assert (root / f).is_file(), f
    assert "AGGREGATE" in (root / "analysis.txt").read_text()
    run = json.loads((root / "run.json").read_text())
    assert [st["stage"] for st in run["stages"]] == ["data", "train", "gen"]
    assert all(st["ok"] and st["seconds"] > 0 and "card" in st for st in run["stages"])
    assert run["epochs_logged"] == 1 and run["nonfinite_epochs"] == 0
    assert run["best_val_rmsd_epoch"] == 1 and run["median_epoch_s"] > 0
    assert len(run["stages"][2]["commands"]) == 4
    # the battery on the kernel path and the plain versions (scripts/battery_paths.py;
    # on the CPU both are the plain versions, so they agree exactly)
    bp = _load("battery_paths", "scripts/battery_paths.py")
    out = bp.main(["--checkpoint", str(root / "ckpt" / "best"), "--manifest",
                   str(root / "data" / "manifest_val.csv"), "--out_dir", str(root),
                   "--tag", "t", "--num_samples", "2", "--device", "cpu", "--",
                   "--refine_steps", "0"])
    assert out["paths"]["kernel"]["aggregate"] == out["paths"]["plain"]["aggregate"]
    assert (root / "battery_t.json").is_file() and (root / "analysis_t_plain.txt").is_file()


def test_plain_routing_routes_every_kernel_off(port):
    import torch

    import protein_ensemble_vae_torch.infer.refine as refine
    import protein_ensemble_vae_torch.losses as losses
    from protein_ensemble_vae_torch.ops.kernels import egnn_band

    bp = _load("battery_paths", "scripts/battery_paths.py")
    t = torch.zeros(1)
    mods = (egnn_band, losses, refine)
    before = [m.pallas_policy for m in mods]
    with bp.plain_routing():
        assert not any(m.pallas_policy(t, True) for m in mods)
    assert [m.pallas_policy for m in mods] == before


def test_unknown_stage_exits(port):
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "flagship_run_torch.py"),
                           "nope"], capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "unknown stage" in proc.stderr


def test_time_limit_records_the_cut_stage(tmp_path):
    """A TERM (a time limit around the command) while a stage's command
    runs: the script exits non-zero, run.json records the stage as not ok,
    and the stage's child process is gone."""
    import signal
    import time

    root, pidfile = tmp_path / "run", tmp_path / "child.pid"
    child = (f"import os, time; open({str(pidfile)!r}, 'w').write(str(os.getpid())); "
             "time.sleep(60)")
    script = os.path.join(ROOT, "scripts", "flagship_run_torch.py")
    # main()'s handler, then a stage whose command outlasts the test
    code = (f"import runpy, signal, sys; m = runpy.run_path({script!r}); "
            "signal.signal(signal.SIGTERM, lambda *_: sys.exit(143)); "
            f"m['_stage']('train', {str(root)!r}, "
            f"lambda cmds: m['_run']([[sys.executable, '-c', {child!r}]], cmds))")
    proc = subprocess.Popen([sys.executable, "-c", code])
    deadline = time.time() + 60
    while not pidfile.exists() or not pidfile.read_text():
        assert time.time() < deadline and proc.poll() is None
        time.sleep(0.1)
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=60) == 143
    run = json.loads((root / "run.json").read_text())
    assert [(st["stage"], st["ok"]) for st in run["stages"]] == [("train", False)]
    pid = int(pidfile.read_text())
    for _ in range(50):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.1)
    else:
        raise AssertionError(f"the stage's child {pid} outlived the script")
