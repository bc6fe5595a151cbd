"""ESM-2 parity: the port's ``models/esm2.py`` against the JAX package's
``esm2_forward`` and HuggingFace's ``EsmModel``, on the CPU.

Weights and tokens are made with numpy from a seed and handed to both
sides as numpy arrays (the JAX params tree, carried over by
``models/bridge.esm2_params_from_jax``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from protein_ensemble_vae_torch.models import esm2 as tesm  # noqa: E402
from protein_ensemble_vae_torch.models.bridge import esm2_params_from_jax  # noqa: E402
from protein_ensemble_vae_tpu.models import esm2 as jesm  # noqa: E402

# fp32 on both sides, sums ordered differently by XLA and by torch; 1e-5
# covers 2 layers at hidden 1280 and fails any layout, scale or rotary
# mistake by orders of magnitude.
ATOL = 1e-5
# HF's EsmModel computes attention its own way (and its rotary tables in
# another order): the JAX package holds itself to it at 1e-4.
HF_ATOL = 1e-4
# Bucket padding adds masked keys whose probabilities underflow to 0.
BUCKET_ATOL = 1e-4

SMALL = dict(hidden=64, num_layers=2, num_heads=4, intermediate=256)
T33_HEADS = dict(hidden=1280, num_layers=2, num_heads=20, intermediate=5120)


def _params(cfg, seed=0):
    """A JAX ESM-2 params tree of numpy arrays at activation scale O(1)."""
    rng = np.random.default_rng(seed)
    D, F = cfg.hidden, cfg.intermediate

    def lin(i, o):
        return {"kernel": rng.normal(0, i ** -0.5, (i, o)).astype(np.float32),
                "bias": rng.normal(0, 0.1, o).astype(np.float32)}

    def ln():
        return {"weight": (1 + rng.normal(0, 0.1, D)).astype(np.float32),
                "bias": rng.normal(0, 0.1, D).astype(np.float32)}

    layers = [dict(attn_ln=ln(), q=lin(D, D), k=lin(D, D), v=lin(D, D),
                   attn_out=lin(D, D), ffn_ln=ln(), fc1=lin(D, F), fc2=lin(F, D))
              for _ in range(cfg.num_layers)]
    return {"word_embeddings": rng.normal(0, 1, (cfg.vocab_size, D)).astype(np.float32),
            "layers": layers, "final_ln": ln()}


def _ragged_tokens(seed=1, B=2, T=18):
    """Ragged batch: row 1 padded after 12 tokens, a <mask> in row 0."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, 24, (B, T)).astype(np.int64)
    toks[:, 0] = jesm.CLS_ID
    toks[0, -1] = jesm.EOS_ID
    toks[0, 5] = jesm.MASK_ID
    toks[1, 12:] = jesm.PAD_ID
    toks[1, 11] = jesm.EOS_ID
    return toks, (toks != jesm.PAD_ID).astype(np.float32)


def _port(params, cfg_kw):
    model = tesm.ESM2(tesm.ESM2Config(**cfg_kw))
    model.load_state_dict(esm2_params_from_jax(params, model))
    return model.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def small():
    jcfg = jesm.ESM2Config(**SMALL)
    params = _params(jcfg)
    return params, jcfg, _port(params, SMALL)


@pytest.mark.parametrize("width", ["small", "t33_heads"])
def test_forward_matches_jax(width):
    kw = SMALL if width == "small" else T33_HEADS
    jcfg = jesm.ESM2Config(**kw)
    params = _params(jcfg, seed=len(width))
    toks, amask = _ragged_tokens()
    want = np.asarray(jesm.esm2_forward(params, jnp.asarray(toks),
                                        jnp.asarray(amask), jcfg))
    with torch.no_grad():
        got = _port(params, kw)(torch.from_numpy(toks),
                                torch.from_numpy(amask)).numpy()
    valid = amask > 0.5
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL, rtol=0)
    assert np.isfinite(got).all()


def test_bridge_rejects_leftover_and_mismatch(small):
    params, _, model = small
    bad = dict(params, extra=np.zeros(1, np.float32))
    with pytest.raises(KeyError):
        esm2_params_from_jax(bad, model)
    layers = [dict(layer) for layer in params["layers"]]
    layers[0]["q"] = dict(layers[0]["q"], scale=np.zeros(1, np.float32))
    with pytest.raises(KeyError):
        esm2_params_from_jax(dict(params, layers=layers), model)
    with pytest.raises(KeyError):                 # a layer too few
        esm2_params_from_jax(dict(params, layers=params["layers"][:1]), model)
    wrong = dict(params, word_embeddings=params["word_embeddings"][:, :32])
    with pytest.raises(ValueError):
        esm2_params_from_jax(wrong, model)


def _tiny_hf_model(seed=0, hidden=64, layers=2, heads=4):
    from transformers import EsmConfig
    from transformers.models.esm.modeling_esm import EsmModel

    torch.manual_seed(seed)
    cfg = EsmConfig(
        vocab_size=33, hidden_size=hidden, num_hidden_layers=layers,
        num_attention_heads=heads, intermediate_size=hidden * 4,
        max_position_embeddings=128, position_embedding_type="rotary",
        token_dropout=True, emb_layer_norm_before=False,
        pad_token_id=tesm.PAD_ID, mask_token_id=tesm.MASK_ID, layer_norm_eps=1e-5,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return EsmModel(cfg, add_pooling_layer=False).eval()


def test_hf_conversion_matches_hf_and_jax():
    pytest.importorskip("transformers")
    hf = _tiny_hf_model()
    sd = hf.state_dict()
    tsd, tcfg = tesm.convert_hf_state_dict(sd)
    jparams, jcfg = jesm.convert_hf_state_dict(sd)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.hidden, tcfg.num_layers, tcfg.num_heads, tcfg.intermediate) == (64, 2, 4, 256)

    model = tesm.ESM2(tcfg).eval()
    model.load_state_dict(tsd)
    # the two conversions carry the same numbers
    for k, v in esm2_params_from_jax(jparams, model).items():
        assert torch.equal(v, tsd[k]), k
    # the esm. prefix of EsmForMaskedLM is stripped
    prefixed, _ = tesm.convert_hf_state_dict({f"esm.{k}": v for k, v in sd.items()})
    assert prefixed.keys() == tsd.keys()

    toks, amask = _ragged_tokens(seed=4)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(toks),
                 attention_mask=torch.from_numpy(amask)).last_hidden_state.numpy()
        got = model(torch.from_numpy(toks), torch.from_numpy(amask)).numpy()
    want = np.asarray(jesm.esm2_forward(jparams, jnp.asarray(toks),
                                        jnp.asarray(amask), jcfg))
    valid = amask > 0.5
    np.testing.assert_allclose(got[valid], ref[valid], atol=HF_ATOL, rtol=0)
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL, rtol=0)


def test_tokenize_matches_jax():
    assert tesm.ESM2_TOKENS == jesm.ESM2_TOKENS
    assert (tesm.CLS_ID, tesm.PAD_ID, tesm.EOS_ID, tesm.UNK_ID, tesm.MASK_ID) == (
        jesm.CLS_ID, jesm.PAD_ID, jesm.EOS_ID, jesm.UNK_ID, jesm.MASK_ID)
    for seq in ("MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ", "mkta", "AXBJ*Z", ""):
        np.testing.assert_array_equal(tesm.tokenize(seq), jesm.tokenize(seq))


@pytest.mark.parametrize("sd,hidden,heads", [
    ({"encoder.layer.0.attention.self.rotary_embeddings.inv_freq": np.zeros(16)}, 640, 20),
    ({"encoder.layer.0.attention.self.rotary_embeddings.inv_freq": np.zeros(32)}, 1280, 20),
    ({"x.rotary_embeddings.inv_freq": torch.zeros(8)}, 64, 4),
    ({}, 480, 20),
    ({}, 2560, 40),
])
def test_infer_num_heads(sd, hidden, heads):
    assert tesm._infer_num_heads(sd, hidden) == heads
    assert jesm._infer_num_heads(sd, hidden) == heads


def test_embedder_bucket_invariance_and_jax(small):
    params, jcfg, model = small
    emb = tesm.ESM2Embedder(model.state_dict(), model.config, device="cpu")
    seq = "MKTAYIAKQRQISFVKSHFSRQ"
    reps = emb.embed(seq)
    assert reps.shape == (len(seq), SMALL["hidden"]) and reps.dtype == np.float32
    ids = torch.from_numpy(tesm.tokenize(seq)[None].astype(np.int64))
    with torch.no_grad():
        direct = model(ids).numpy()[0, 1:-1]       # unpadded, no bucket
    np.testing.assert_allclose(reps, direct, atol=BUCKET_ATOL, rtol=0)
    want = jesm.ESM2Embedder(params, jcfg).embed(seq)
    np.testing.assert_allclose(reps, want, atol=ATOL, rtol=0)
    assert [emb._bucket(n) for n in (3, 32, 33, 66, 1024)] == [32, 32, 64, 128, 1024]


def test_embedder_length_cap(small):
    _, _, model = small
    cfg = dataclasses.replace(model.config, max_tokens=16)
    emb = tesm.ESM2Embedder(model.state_dict(), cfg, device="cpu")
    assert emb.embed("A" * 16).shape == (16, SMALL["hidden"])
    with pytest.raises(ValueError):
        emb.embed("A" * 17)


def test_embedder_cuda_raises_without_gpu(small):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, model = small
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tesm.ESM2Embedder(model.state_dict(), model.config)


def test_init_hf_draws_hf_statistics():
    cfg = tesm.ESM2Config(**SMALL)
    model = tesm.init_hf_(tesm.ESM2(cfg), torch.Generator().manual_seed(0)).requires_grad_(False)
    again = tesm.init_hf_(tesm.ESM2(cfg), torch.Generator().manual_seed(0))
    for (k, v), w in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(v, w), k
    fc1 = model.layers[0].fc1.weight
    assert abs(float(fc1.std()) - 0.02) < 2e-3 and float(model.layers[1].q.bias.abs().max()) == 0
    assert float(model.final_ln.weight.min()) == 1.0
    assert float(model.word_embeddings.weight[tesm.PAD_ID].abs().max()) == 0.0


def _offline(monkeypatch):
    """No hub traffic: offline mode in the environment and in the loaded
    hub constants, and a path that is no valid repository id."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    hub = pytest.importorskip("huggingface_hub")
    monkeypatch.setattr(hub.constants, "HF_HUB_OFFLINE", True, raising=False)


def test_load_hf_esm2_missing_checkpoint_raises(monkeypatch, tmp_path):
    pytest.importorskip("transformers")
    _offline(monkeypatch)
    with pytest.raises(RuntimeError, match="could not load"):
        tesm.load_hf_esm2(str(tmp_path / "no" / "such" / "checkpoint"))


def test_esm_embedder_missing_checkpoint_raises(monkeypatch, tmp_path):
    pytest.importorskip("transformers")
    from protein_ensemble_vae_torch.dataprep.esm import ESMEmbedder

    _offline(monkeypatch)
    with pytest.raises(RuntimeError, match="could not load"):
        ESMEmbedder(str(tmp_path / "no" / "such" / "checkpoint"), device="cpu")


def test_esm_embedder_runs_the_port_forward(monkeypatch, small):
    """``ESMEmbedder`` is the loaded checkpoint on ``ESM2Embedder``: the same
    output as JAX's embedder on the same weights, and the same residue cap."""
    from protein_ensemble_vae_torch.dataprep import esm as tesm_prep

    params, jcfg, model = small
    cfg = dataclasses.replace(model.config, max_tokens=24)
    names = []

    def fake_load(name):
        names.append(name)
        return model.state_dict(), cfg

    monkeypatch.setattr(tesm, "load_hf_esm2", fake_load)
    emb = tesm_prep.ESMEmbedder(device="cpu")
    assert names == [tesm_prep.MODEL_NAME]
    seq = "MKTAYIAKQRQISFVKSHFSRQ"
    np.testing.assert_allclose(emb.embed(seq), jesm.ESM2Embedder(params, jcfg).embed(seq),
                               atol=ATOL, rtol=0)
    with pytest.raises(ValueError):
        emb.embed("A" * 25)
