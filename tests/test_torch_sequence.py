"""Sequence helpers of the port (``protein_ensemble_vae_torch.infer.sequence``)
against the JAX package's ``infer/sequence.py``: the eight cases of
``tests/test_sequence.py``, each on the same numpy inputs through both
functions. 'sample' is compared by distribution, as the JAX test does: the
two draw from different generators."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from protein_ensemble_vae_torch.infer import sequence as T  # noqa: E402
from protein_ensemble_vae_tpu.config import AA_ORDER  # noqa: E402
from protein_ensemble_vae_tpu.infer import sequence as J  # noqa: E402


def test_onehot_roundtrip():
    seq = "ARNDCQEGHILKMFPSTWYV"
    oh = T.sequence_to_onehot(seq)
    assert oh.shape == (20, 20) and oh.dtype == np.float32
    np.testing.assert_array_equal(oh, J.sequence_to_onehot(seq))
    assert np.allclose(oh, np.eye(20))


def test_onehot_unknown_uniform():
    oh = T.sequence_to_onehot("AXB")  # X and B are not in the 20-AA table
    np.testing.assert_array_equal(oh, J.sequence_to_onehot("AXB"))
    assert np.allclose(oh[1], 1.0 / 20.0) and np.allclose(oh[2], 1.0 / 20.0)
    assert oh[0, 0] == 1.0


def test_argmax_decode():
    logits = T.sequence_to_onehot("GLYW") * 10.0
    assert T.tensor_to_sequence(torch.from_numpy(logits)) == \
        J.tensor_to_sequence(logits) == "GLYW"
    # a numpy array is taken as it is
    assert T.tensor_to_sequence(logits) == "GLYW"


def test_sample_decode_follows_distribution():
    logits = T.sequence_to_onehot("MKV" * 10) * 50.0
    g = torch.Generator().manual_seed(0)
    out = T.tensor_to_sequence(torch.from_numpy(logits), method="sample", generator=g)
    assert out == J.tensor_to_sequence(logits, method="sample",
                                       rng=jax.random.PRNGKey(0)) == "MKV" * 10
    # uniform logits: both vary across positions, over the same classes
    flat = np.zeros((200, 20), np.float32)
    got = T.logits_to_labels(torch.from_numpy(flat), "sample",
                             generator=torch.Generator().manual_seed(1)).numpy()
    want = np.asarray(J.logits_to_labels(flat, "sample", rng=jax.random.PRNGKey(1)))
    assert len(set(got.tolist())) > 5 and len(set(want.tolist())) > 5
    assert got.min() >= 0 and got.max() < 20


def test_threshold_decode():
    logits = T.sequence_to_onehot("AC") * 10.0
    assert T.tensor_to_sequence(torch.from_numpy(logits), method="threshold") == \
        J.tensor_to_sequence(logits, method="threshold") == "AC"
    flat = np.zeros((3, 20), np.float32)
    assert T.tensor_to_sequence(torch.from_numpy(flat), method="threshold") == \
        J.tensor_to_sequence(flat, method="threshold") == "AAA"


def test_unknown_method_raises():
    for fn, kw in ((T.logits_to_labels, {}), (J.logits_to_labels, {})):
        with pytest.raises(ValueError):
            fn(np.zeros((2, 20), np.float32) if fn is J.logits_to_labels
               else torch.zeros(2, 20), "beam", **kw)
    with pytest.raises(ValueError):
        T.logits_to_labels(torch.zeros(2, 20), "sample")  # no generator
    with pytest.raises(ValueError):
        J.logits_to_labels(np.zeros((2, 20), np.float32), "sample")  # no rng


def test_accuracy_vs_string():
    seq = "ARND"
    logits = (T.sequence_to_onehot(seq) * 10.0)[None]
    wrong_tail = (T.sequence_to_onehot("ARAA") * 10.0)[None]
    mask = np.array([[1.0, 1.0, 0.0, 0.0]], np.float32)
    cases = [(logits, None, 1.0), (wrong_tail, mask, 1.0), (wrong_tail, None, 0.5),
             (wrong_tail, np.zeros_like(mask), 0.0)]
    for lg, m, want in cases:
        got = T.sequence_accuracy_vs_string(
            torch.from_numpy(lg), seq, None if m is None else torch.from_numpy(m))
        assert got == J.sequence_accuracy_vs_string(lg, seq, m) == want


def test_to_3letter():
    for s in ("AR", "X", AA_ORDER + "BZ"):
        assert T.to_3letter(s) == J.to_3letter(s)
    assert T.to_3letter("AR") == ["ALA", "ARG"] and T.to_3letter("X") == ["ALA"]
