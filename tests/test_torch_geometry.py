"""Geometry parity: the port's ops/geometry.py against the JAX package's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from protein_ensemble_vae_torch.ops import geometry as tg  # noqa: E402
from protein_ensemble_vae_tpu.ops import geometry as jg  # noqa: E402

# fp32 SVD / cross products computed by two libraries: 1e-5 absolute on
# Angstrom-scale RMSDs and unit (sin, cos) pairs.
ATOL = 1e-5


def _mask(rng, B, L):
    m = (rng.random((B, L)) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    return m


def test_compact_and_scatter_agree_exactly():
    rng = np.random.default_rng(0)
    mask = _mask(rng, 3, 29)
    mask[2] = 0.0                     # an all-padding row
    x = rng.normal(0, 1, (3, 29, 5)).astype(np.float32)
    pos, inv, cm = jg.compact_valid(jnp.array(mask))
    tpos, tinv, tcm = tg.compact_valid(torch.from_numpy(mask))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(inv))
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(cm))
    want = jg.scatter_compact(jnp.array(x), inv, jnp.array(mask))
    got = tg.scatter_compact(torch.from_numpy(x), tinv, torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kabsch_rmsd_parity():
    rng = np.random.default_rng(1)
    P = rng.normal(0, 5, (30, 3)).astype(np.float32)
    Q = rng.normal(0, 5, (30, 3)).astype(np.float32)
    mask = _mask(rng, 1, 30)[0]
    for m in (None, mask):
        want = jg.kabsch_rmsd(jnp.array(P), jnp.array(Q),
                              None if m is None else jnp.array(m))
        got = tg.kabsch_rmsd(torch.from_numpy(P), torch.from_numpy(Q),
                             None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), atol=ATOL)
    # a rigid motion of P aligns back onto itself
    R, _ = np.linalg.qr(rng.normal(0, 1, (3, 3)))
    R *= np.sign(np.linalg.det(R))
    P2 = (P @ R.T + 3.0).astype(np.float32)
    assert float(tg.kabsch_rmsd(torch.from_numpy(P2), torch.from_numpy(P))) < 1e-4


def test_pairwise_kabsch_rmsd_parity():
    rng = np.random.default_rng(2)
    X = rng.normal(0, 4, (5, 24, 3)).astype(np.float32)
    mask = _mask(rng, 1, 24)[0]
    want = jg.pairwise_kabsch_rmsd(jnp.array(X), jnp.array(mask))
    got = tg.pairwise_kabsch_rmsd(torch.from_numpy(X), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_dihedrals_parity_with_degenerate_points():
    rng = np.random.default_rng(3)
    B, L = 2, 20
    n, ca, c = (rng.normal(0, 2, (B, L, 3)).astype(np.float32)
                for _ in range(3))
    # collinear residue: N, CA, C on one line (undefined plane normals)
    line = np.array([1.0, 2.0, -0.5], np.float32)
    n[0, 5], ca[0, 5], c[0, 5] = 0.0 * line, 1.0 * line, 2.0 * line
    n[0, 6] = 3.0 * line
    # coincident atoms
    ca[1, 9] = n[1, 9]
    mask = _mask(rng, B, L)
    want = jg.dihedrals_from_coords(*(jnp.array(v) for v in (n, ca, c, mask)))
    got = tg.dihedrals_from_coords(*(torch.from_numpy(v) for v in (n, ca, c, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert np.isfinite(got.numpy()).all()


def test_safe_normalize_parity():
    rng = np.random.default_rng(4)
    v = rng.normal(0, 1, (7, 3)).astype(np.float32)
    v[0] = 0.0
    v[1] = 1e-6
    want = jg.safe_normalize(jnp.array(v))
    got = tg.safe_normalize(torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
