"""Torsion-space refinement of the PyTorch port (``infer/torsion_refine.py``)
against the JAX package's, on the CPU: the seed frame, torsion extraction,
the NeRF rebuild (the port's prefix product against JAX's ``lax.scan`` and
against the port's own sequential plain version), and ``refine_torsions``.

Inputs are made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from protein_ensemble_vae_torch.config import (BOND_C_N, BOND_CA_C,  # noqa: E402
                                               BOND_N_CA)
from protein_ensemble_vae_torch.infer import torsion_refine as T  # noqa: E402
from protein_ensemble_vae_tpu.data.synthetic import nerf_ensemble  # noqa: E402
from protein_ensemble_vae_tpu.infer import torsion_refine as J  # noqa: E402

B, L, L_REAL = 2, 40, 34
# The JAX package builds the chain sequentially in fp32; its own rounding
# drifts ~1-2e-4 A from the exact chain by L = 64 (the port's sequential
# fp32 build differs from it by 1.7e-4 A there, while the port's prefix
# product composes in float64). So rebuilt coordinates are held to 5e-4 A.
REBUILD_ATOL = 5e-4


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def fold():
    n, ca, c = nerf_ensemble(64, B, seed=1)
    return n, ca, c, np.ones((B, 64), np.float32)


@pytest.fixture(scope="module")
def noisy():
    """A noised NeRF fold padded from L_REAL to L (padding nonzero)."""
    n, ca, c = nerf_ensemble(L_REAL, B, seed=2)
    rng = np.random.default_rng(7)
    out = []
    for x in (n, ca, c):
        x = 0.9 * x + rng.normal(0, 0.25, x.shape)
        out.append(np.concatenate([x, rng.normal(0, 5.0, (B, L - L_REAL, 3))],
                                  1).astype(np.float32))
    mask = np.zeros((B, L), np.float32)
    mask[:, :L_REAL] = 1.0
    mask[1, 10] = 0.0
    return (*out, mask)


def _wrapped(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs(np.arctan2(np.sin(d), np.cos(d)))


def test_seed_frame_and_torsions_match_jax(noisy):
    """ideal_seed_frame to 1e-6 A; torsions to 1e-5 rad, compared on the
    circle (a value at +-pi may land on either side), masked pairs and
    chain ends included."""
    n, ca, c, mask = noisy
    want = J.ideal_seed_frame(n[:, 0], ca[:, 0], c[:, 0])
    got = T.ideal_seed_frame(_t(n[:, 0]), _t(ca[:, 0]), _t(c[:, 0]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    want = J.torsions_from_coords(n, ca, c, mask)
    got = T.torsions_from_coords(_t(n), _t(ca), _t(c), _t(mask))
    for name, g, w in zip(("phi", "psi", "omega"), got, want):
        assert _wrapped(g.numpy(), w).max() < 1e-5, name
    # undefined omega is trans (pi), undefined phi / psi are 0
    assert float(got[2][1, 11]) == pytest.approx(np.pi)
    assert float(got[0][0, 0]) == 0.0 and float(got[1][0, L - 1]) == 0.0


def test_nerf_rebuild_matches_jax(fold):
    """The prefix-product rebuild against the JAX scan at L = 64, from the
    same torsions and seed: within REBUILD_ATOL."""
    n, ca, c, mask = fold
    tors = J.torsions_from_coords(n, ca, c, mask)
    seed = J.ideal_seed_frame(n[:, 0], ca[:, 0], c[:, 0])
    want = J.nerf_rebuild(*tors, *seed)
    got = T.nerf_rebuild(*(_t(x) for x in tors), *(_t(x) for x in seed))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=REBUILD_ATOL, rtol=0)


def test_nerf_rebuild_degenerate_seed_collapses_as_jax(fold):
    """The ``ADVICE.md`` low finding at the JAX package's
    ``torsion_refine.py:173``, kept as the reference has it: a residue 0 at
    the origin (masked, as a model that lacks it is read) gives a zero
    seed frame, and both builds collapse the whole chain onto it."""
    n, ca, c, mask = (np.array(x) for x in fold)
    for x in (n, ca, c):
        x[:, 0] = 0.0
    mask[:, 0] = 0.0
    tors = J.torsions_from_coords(n, ca, c, mask)
    seed = J.ideal_seed_frame(n[:, 0], ca[:, 0], c[:, 0])
    want = J.nerf_rebuild(*tors, *seed)
    got = T.nerf_rebuild(*(_t(x) for x in tors), *(_t(x) for x in seed))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(w), 0.0)
        np.testing.assert_array_equal(g.numpy(), 0.0)


def test_scan_matches_sequential_build_at_full_length():
    """The prefix product against the port's sequential plain version at
    L = 640, both in float64 (1e-8 A; measured 2.5e-11), and the fp32
    path against the float64 sequential build (1e-3 A; measured 4.6e-4,
    the rounding of the fp32 torsions themselves)."""
    n, ca, c = nerf_ensemble(640, 2, seed=0, max_tries=8)
    mask = torch.ones(2, 640, dtype=torch.float64)
    xs = [torch.tensor(x, dtype=torch.float64) for x in (n, ca, c)]
    tors = T.torsions_from_coords(*xs, mask)
    seed = T.ideal_seed_frame(*(x[:, 0] for x in xs))
    want = T.nerf_rebuild_reference(*tors, *seed)
    got = T.nerf_rebuild(*tors, *seed)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert float((g - w).abs().max()) < 1e-8
    got32 = T.nerf_rebuild(*(t.float() for t in tors), *(s.float() for s in seed))
    for g, w in zip(got32, want):
        assert float((g.double() - w).abs().max()) < 1e-3
    # ideal bonds at fp32 output precision
    bn, bca, bc = got32
    for a, b, ref in ((bn, bca, BOND_N_CA), (bca, bc, BOND_CA_C),
                      (bc[:, :-1], bn[:, 1:], BOND_C_N)):
        assert float(((b - a).norm(dim=-1) - ref).abs().max()) < 1e-4


def test_nerf_rebuild_gradient_matches_sequential():
    """Autograd through the prefix product equals autograd through the
    sequential build (float64, L = 24)."""
    n, ca, c = nerf_ensemble(24, 1, seed=4)
    xs = [torch.tensor(x, dtype=torch.float64) for x in (n, ca, c)]
    tors = [t.detach().requires_grad_(True) for t in
            T.torsions_from_coords(*xs, torch.ones(1, 24, dtype=torch.float64))]
    seed = T.ideal_seed_frame(*(x[:, 0] for x in xs))
    w = torch.linspace(-1, 1, 24 * 3, dtype=torch.float64).reshape(1, 24, 3)
    grads = []
    for build in (T.nerf_rebuild, T.nerf_rebuild_reference):
        loss = sum((x * w).sum() for x in build(*tors, *seed))
        grads.append(torch.autograd.grad(loss, tors))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("include_o", [False, True])
def test_refine_torsions_20_steps_match_jax(noisy, include_o):
    """20 Adam steps on the torsions, the vdW term with and without the
    carbonyl O: coordinates within REBUILD_ATOL of the JAX package's,
    padded rows equal to the input exactly, bonds ideal."""
    n, ca, c, mask = noisy
    kw = dict(steps=20, lr=0.02, anchor_weight=0.01, w_rama=2.0, w_omega=1.0,
              w_clash_vdw=400.0, lr_decay=True, vdw_include_o=include_o)
    want = J.refine_torsions(n, ca, c, mask, **kw)
    got = T.refine_torsions(_t(n), _t(ca), _t(c), _t(mask), **kw)
    for g, w, x in zip(got, want, (n, ca, c)):
        g = g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), atol=REBUILD_ATOL, rtol=0)
        np.testing.assert_array_equal(g[mask == 0], x[mask == 0])
    bn, bca = got[0].numpy(), got[1].numpy()
    d = np.linalg.norm(bca - bn, axis=-1)[mask > 0]
    assert np.abs(d - BOND_N_CA).max() < 1e-4
    assert np.abs(got[1].numpy() - ca)[mask > 0].max() > 1e-2


def test_refine_torsions_zero_steps_is_the_projection(noisy):
    """steps = 0: the projection onto the manifold alone, as JAX's."""
    n, ca, c, mask = noisy
    want = J.refine_torsions(n, ca, c, mask, steps=0)
    got = T.refine_torsions(_t(n), _t(ca), _t(c), _t(mask), steps=0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=REBUILD_ATOL, rtol=0)


def test_refine_torsions_degenerate_seed(noisy):
    """With residue 0 at the origin the chain collapses in both packages
    (the ADVICE.md finding, see above). With steps > 0 the JAX package's
    gradient through the zero-length unit vectors of its sequential build
    is NaN, so its collapsed model comes out NaN; the port's gradient
    through the zero seed frame is exactly 0, so its model stays at the
    origin. The other model agrees within REBUILD_ATOL."""
    n, ca, c, mask = (np.array(x) for x in noisy)
    for x in (n, ca, c):
        x[1, 0] = 0.0
    mask[1, 0] = 0.0
    kw = dict(steps=5, lr_decay=True, w_clash_vdw=25.0)
    want = [np.asarray(x) for x in J.refine_torsions(n, ca, c, mask, **kw)]
    got = [x.numpy() for x in T.refine_torsions(_t(n), _t(ca), _t(c), _t(mask), **kw)]
    valid = mask[1] > 0
    for g, w in zip(got, want):
        assert np.isnan(w[1][valid]).all()
        np.testing.assert_array_equal(g[1][valid], 0.0)
        np.testing.assert_allclose(g[0], w[0], atol=REBUILD_ATOL, rtol=0)
