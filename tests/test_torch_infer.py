"""The port's configuration, sequence decoding, geometry gate, checkpoint
and prior sampling, held against the JAX package where it has a
counterpart."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from protein_ensemble_vae_torch import config as tconfig  # noqa: E402
from protein_ensemble_vae_torch.infer.gate import validate_protein_geometry as tgate  # noqa: E402
from protein_ensemble_vae_torch.infer.sequence import logits_to_labels  # noqa: E402
from protein_ensemble_vae_torch.models import HierCVAE  # noqa: E402
from protein_ensemble_vae_torch.train.checkpoint import (load_checkpoint,  # noqa: E402
                                                         load_run_config,
                                                         save_checkpoint)
from protein_ensemble_vae_tpu import config as jconfig  # noqa: E402
from protein_ensemble_vae_tpu.infer.gate import validate_protein_geometry as jgate  # noqa: E402
from protein_ensemble_vae_tpu.infer.sequence import logits_to_labels as jax_logits_to_labels  # noqa: E402

SMALL = dict(seqemb_dim=8, d_model=32, nhead=4, ff=64, nlayers=1,
             z_global=16, z_local=8, decoder_hidden=16, decoder_layers=2,
             max_neighbors=4)


@pytest.mark.parametrize("kw", [{}, dict(model=SMALL, train={"bucket_sizes": (16, 32)})])
def test_run_config_json_is_the_same_contract(kw):
    def build(mod):
        return mod.RunConfig(model=mod.ModelConfig(**kw.get("model", {})),
                             train=mod.TrainConfig(**kw.get("train", {})))
    j, t = build(jconfig), build(tconfig)
    assert t.to_json() == j.to_json()
    assert tconfig.RunConfig.from_json(j.to_json()) == t
    assert json.loads(t.to_json())["model"]["use_pallas_egnn"] == "auto"
    assert tconfig.AA_ORDER == jconfig.AA_ORDER
    assert tconfig.AA_3TO1 == jconfig.AA_3TO1


@pytest.mark.parametrize("method", ["argmax", "threshold"])
def test_logits_to_labels_matches_jax(method):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (3, 17, 20)).astype(np.float32)
    logits[0, :5, 4] += 6.0       # confident rows clear the threshold
    want = jax_logits_to_labels(jnp.array(logits), method, threshold=0.5)
    got = logits_to_labels(torch.from_numpy(logits), method, threshold=0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_labels_follow_the_generator():
    logits = torch.randn(40, 20, generator=torch.Generator().manual_seed(1))
    a = logits_to_labels(logits, "sample",
                         generator=torch.Generator().manual_seed(7))
    b = logits_to_labels(logits, "sample",
                         generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and a.shape == (40,)
    assert int(a.min()) >= 0 and int(a.max()) < 20
    # a near-one-hot distribution is sampled at its mode
    peaked = torch.full((5, 20), -50.0)
    peaked[:, 3] = 50.0
    assert torch.all(logits_to_labels(
        peaked, "sample", generator=torch.Generator().manual_seed(0)) == 3)
    with pytest.raises(ValueError, match="generator"):
        logits_to_labels(logits, "sample")


def test_geometry_gate_matches_jax():
    rng = np.random.default_rng(5)
    L = 30
    t = np.arange(L) * 100.0 * np.pi / 180.0
    helix = np.stack([2.3 * np.cos(t), 2.3 * np.sin(t), 1.5 * np.arange(L)], -1)
    mask = np.ones(L, np.float32)
    mask[7] = 0.0
    cases = [helix, helix * 3.0, helix * 0.3,
             helix + rng.normal(0, 2.0, helix.shape),
             rng.normal(0, 20, (L, 3))]
    for ca in cases:
        assert tgate(ca.astype(np.float32), mask) == jgate(ca.astype(np.float32), mask)
    assert tgate(helix, np.zeros(L)) == jgate(helix, np.zeros(L))


def test_checkpoint_round_trip(tmp_path):
    cfg = tconfig.RunConfig(model=tconfig.ModelConfig(**SMALL))
    torch.manual_seed(0)
    model = HierCVAE(cfg.model)
    save_checkpoint(str(tmp_path / "ck"), model, cfg, epoch=3)
    assert load_run_config(str(tmp_path / "ck")) == cfg
    torch.manual_seed(1)
    fresh = HierCVAE(load_run_config(str(tmp_path / "ck")).model)
    load_checkpoint(str(tmp_path / "ck"), fresh)
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert meta["epoch"] == 3 and meta["format_version"] == 1


def test_prior_sample_shapes_and_padding():
    torch.manual_seed(0)
    model = HierCVAE(tconfig.ModelConfig(**SMALL)).eval()
    mask = torch.ones(2, 20)
    mask[1, 15:] = 0.0
    with torch.no_grad():
        n, ca, c, seq = model.sample(mask, num_samples=3,
                                     generator=torch.Generator().manual_seed(2))
    assert ca.shape == (6, 20, 3) and seq.shape == (6, 20, 20)
    assert torch.isfinite(n).all() and torch.isfinite(c).all()
    # rows 3..5 decode the second structure: padded positions are zero
    assert float(ca[3:, 15:].abs().max()) == 0.0
