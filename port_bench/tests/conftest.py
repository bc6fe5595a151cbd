"""A checkout root in a temporary directory with the benchmark's files and
tiny cells added as files, for CPU runs of the harness."""

from __future__ import annotations

import json
import os
import shutil

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

TINY_MODEL = dict(seqemb_dim=16, d_model=32, nhead=4, ff=64, nlayers=1, z_global=16,
                  z_local=8, dropout=0.1, decoder_hidden=16, decoder_layers=2,
                  max_neighbors=4, degree_normalize=True, decoder_remat=False,
                  use_pallas_egnn="auto", use_seqemb=True, use_dihedrals=True,
                  num_aa_types=20, max_len=4096)


def add_cell(root: str, name: str, config: str, traffic: str, limits: dict,
             metric: str = None) -> None:
    """Add a cell to ``root``'s BENCHMARK.json (it reports the end-to-end
    metric of its traffic's driver); with ``metric``, also a per-layer
    metric of that name reported in it."""
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append(dict(name=name, config=config, traffic=traffic, chips=1,
                                   why="a tiny cell for CPU tests"))
    with open(os.path.join(root, "port_bench", "traffic", traffic + ".json")) as f:
        driver = json.load(f)["driver"]
    kind = "train_residues_per_s" if driver == "train" else "gen_residues_per_s"
    for m in bench["end_to_end"]:
        if m["name"] == kind:
            m["workloads"].append(name)
    for m in bench["per_layer"]:
        if "workloads" in m and m["moves"] == kind:
            m["workloads"].append(name)
    if metric:
        bench["per_layer"].append(dict(name=metric, unit="1", better="higher",
                                       source="program_counter", layer="tests", moves=kind,
                                       workloads=[name]))
    with open(path, "w") as f:
        json.dump(bench, f)
    with open(os.path.join(root, "port_bench", "limits", name + ".json"), "w") as f:
        json.dump(limits, f)


@pytest.fixture
def tiny_root(tmp_path):
    """A root with BENCHMARK.json, the benchmark's data files and the tiny
    configuration and traffic files ``pev-tiny``, ``pairs-tiny`` and
    ``polish-tiny`` (cells are added by ``add_cell``)."""
    root = str(tmp_path / "checkout")
    os.makedirs(os.path.join(root, "port_bench"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(root, "port_bench", d))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(name="pev-tiny", source="tests", reduced=[], why="tests",
                                 file="port_bench/configs/pev-tiny.json"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    files = {
        "configs/pev-tiny.json": dict(name="pev-tiny", model=TINY_MODEL),
        "traffic/pairs-tiny.json": dict(
            driver="train", proteins=3, lengths=[12, 40], conformers=3, fold_tries=4,
            batch_size=4, buckets=[16, 32, 48], lr=3e-5, grad_clip=10.0, klw_global=1.0,
            klw_local=0.5, checked_steps=3,
            loss_weights=json.load(open(os.path.join(BENCH, "traffic", "pairs-b16-len50-600.json")))["loss_weights"]),
        "traffic/polish-tiny.json": dict(
            driver="generate", structures=2, lengths=[12, 30], fold_tries=4, num_samples=3,
            temperature=0.7, refine_mode="polish", refine_steps=5, refine_lr=0.05,
            refine_anchor=0.05, refine_w_rama=0.5,
            refine_kwargs=dict(w_angle=0.5, w_bond=1.0, w_clash_vdw=0.0, lr_decay=False),
            buckets=[16, 32], checked_ensembles=2, traced_calls=2),
    }
    for rel, obj in files.items():
        with open(os.path.join(root, "port_bench", rel), "w") as f:
            json.dump(obj, f)
    return root
