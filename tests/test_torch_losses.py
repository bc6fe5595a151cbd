"""Loss battery parity: every term of the port's ``losses.py`` against the
JAX package's, value and gradient (torch autograd vs ``jax.grad``), on the
same numpy inputs, including degenerate geometry: coincident atoms,
collinear triples, and undefined torsions stored as (sin, cos) = (0, 0).
The gradients must be finite on both sides and equal.

Tolerance: values rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6
(fp32 on both sides, reductions in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import protein_ensemble_vae_torch.losses as TL  # noqa: E402
import protein_ensemble_vae_tpu.losses as JL  # noqa: E402
from protein_ensemble_vae_torch.config import LossWeights as TWeights  # noqa: E402
from protein_ensemble_vae_torch.ops import geometry as TG  # noqa: E402
from protein_ensemble_vae_tpu.config import LossWeights as JWeights  # noqa: E402
from protein_ensemble_vae_tpu.ops import geometry as JG  # noqa: E402

V_RTOL, V_ATOL = 1e-5, 1e-6
G_RTOL, G_ATOL = 1e-4, 1e-6
B, L = 2, 14


def _backbone(seed=0, degenerate=False):
    rng = np.random.default_rng(seed)
    ca = np.cumsum(rng.normal(0, 2.2, (B, L, 3)), axis=1).astype(np.float32)
    n = (ca + rng.normal(0, 0.9, (B, L, 3))).astype(np.float32)
    c = (ca + rng.normal(0, 0.9, (B, L, 3))).astype(np.float32)
    mask = np.ones((B, L), np.float32)
    mask[0, -3:] = 0.0
    mask[1, 6] = 0.0
    if degenerate:
        n[0, 2] = ca[0, 2]                       # coincident N / CA
        ca[1, 4] = ca[1, 5]                      # coincident consecutive CAs
        c[0, 7] = 2 * ca[0, 7] - n[0, 7]         # collinear N-CA-C
        n[0, 8] = c[0, 7] + (c[0, 7] - ca[0, 7])  # collinear CA-C-N(i+1)
    return n, ca, c, mask


def _dihedrals(seed=1, zero_pairs=True):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-np.pi, np.pi, (B, L, 3))
    dih = np.stack([np.sin(ang), np.cos(ang)], -1).reshape(B, L, 6).astype(np.float32)
    if zero_pairs:
        dih[0, 0, 0:2] = 0.0                     # undefined phi
        dih[0, -1, 2:4] = 0.0                    # undefined psi
        dih[1, 3, 4:6] = 0.0                     # undefined omega
    return dih


def _check(jfn, tfn, args, diff, ct_seed=5):
    """Value and gradient (w.r.t. args[i] for i in diff) of jfn vs tfn. A
    non-scalar output is reduced by a fixed numpy cotangent."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    targs = [torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a for a in args]
    for i in diff:
        targs[i].requires_grad_(True)
    t_out = tfn(*targs)
    j_out = jfn(*jargs)
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               rtol=V_RTOL, atol=V_ATOL)
    ct = np.random.default_rng(ct_seed).normal(0, 1, np.shape(j_out)).astype(np.float32)

    def jscalar(*d):
        a = list(jargs)
        for i, v in zip(diff, d):
            a[i] = v
        return jnp.sum(jfn(*a) * ct)

    jg = jax.grad(jscalar, argnums=tuple(range(len(diff))))(*[jargs[i] for i in diff])
    tg = torch.autograd.grad(torch.sum(t_out * torch.from_numpy(ct)),
                             [targs[i] for i in diff], allow_unused=True)
    for i, g_t, g_j in zip(diff, tg, jg):
        g_j = np.asarray(g_j)
        g_t = np.zeros_like(g_j) if g_t is None else g_t.numpy()
        assert np.isfinite(g_j).all() and np.isfinite(g_t).all(), f"arg {i}"
        np.testing.assert_allclose(g_t, g_j, rtol=G_RTOL, atol=G_ATOL,
                                   err_msg=f"grad of arg {i}")


@pytest.mark.parametrize("degenerate", [False, True])
@pytest.mark.parametrize("name", [
    "bond_length_loss", "bond_angle_loss", "ca_spacing_loss", "clash_loss",
    "carbonyl_oxygen", "vdw_clash_loss", "vdw_clash_loss_o",
    "dihedrals_from_coords"])
def test_coordinate_terms(name, degenerate):
    n, ca, c, mask = _backbone(seed=3, degenerate=degenerate)
    if name == "ca_spacing_loss":
        _check(JL.ca_spacing_loss, TL.ca_spacing_loss, [ca, mask], [0])
        return
    if name == "vdw_clash_loss_o":
        jf = lambda *a: JL.vdw_clash_loss(*a, include_o=True)  # noqa: E731
        tf = lambda *a: TL.vdw_clash_loss(*a, include_o=True)  # noqa: E731
    elif name == "dihedrals_from_coords":
        jf, tf = JG.dihedrals_from_coords, TG.dihedrals_from_coords
    else:
        jf, tf = getattr(JL, name), getattr(TL, name)
    if name in ("clash_loss", "vdw_clash_loss", "vdw_clash_loss_o"):
        n, ca, c = 0.3 * n, 0.3 * ca, 0.3 * c   # crowded: many violations
    _check(jf, tf, [n, ca, c, mask], [0, 1, 2])


def test_bond_length_delta_scale():
    n, ca, c, mask = _backbone(seed=4)
    _check(lambda *a: JL.bond_length_loss(*a, delta_scale=25.0),
           lambda *a: TL.bond_length_loss(*a, delta_scale=25.0),
           [n, ca, c, mask], [0, 1, 2])


def test_reconstruction_terms():
    n, ca, c, mask = _backbone(seed=5)
    tgt = _backbone(seed=6)[1]
    _check(JL.rmsd_loss, TL.rmsd_loss, [ca, tgt, mask], [0, 1])
    for stride in (1, 4, 8):
        _check(lambda p, t, m: JL.pair_distance_loss(p, t, m, stride=stride),
               lambda p, t, m: TL.pair_distance_loss(p, t, m, stride=stride),
               [ca, tgt, mask], [0, 1])


def test_pair_distance_loss_coincident_points():
    n, ca, c, mask = _backbone(seed=5)
    ca[0, 4] = ca[0, 0]      # stride 4: two sampled points coincide
    _check(lambda p, t, m: JL.pair_distance_loss(p, t, m, stride=4),
           lambda p, t, m: TL.pair_distance_loss(p, t, m, stride=4),
           [ca, n, mask], [0, 1])


def test_kl_terms():
    rng = np.random.default_rng(7)
    mu_g = rng.normal(0, 1, (B, 6)).astype(np.float32)
    lv_g = rng.normal(-1, 1, (B, 6)).astype(np.float32)
    mu_l = rng.normal(0, 1, (B, L, 4)).astype(np.float32)
    lv_l = rng.normal(-1, 1, (B, L, 4)).astype(np.float32)
    mask = _backbone()[3]
    _check(JL.kl_global, TL.kl_global, [mu_g, lv_g], [0, 1])
    _check(JL.kl_local, TL.kl_local, [mu_l, lv_l, mask], [0, 1])
    for reduce in ("mean", "sum", "none"):
        for m in (mask, None):
            _check(lambda a, b, mm: JL.free_bits_kl(a, b, mm, free_bits=0.3,
                                                    min_kl=0.1, reduce=reduce),
                   lambda a, b, mm: TL.free_bits_kl(a, b, mm, free_bits=0.3,
                                                    min_kl=0.1, reduce=reduce),
                   [mu_l, lv_l, m], [0, 1])


def test_torsion_terms():
    dih = _dihedrals()
    tgt = _dihedrals(seed=2, zero_pairs=False)
    tgt[1, 2, 3] = np.inf                    # a non-finite target element
    mask = _backbone()[3]
    _check(JL.dihedral_consistency_loss, TL.dihedral_consistency_loss,
           [dih, tgt, mask], [0])
    _check(JL.ramachandran_loss, TL.ramachandran_loss, [dih, mask], [0])
    _check(JL.omega_trans_loss, TL.omega_trans_loss, [dih, mask], [0])


def test_geometry_helpers_at_degenerate_points():
    rng = np.random.default_rng(8)
    y = rng.normal(0, 1, (3, 5)).astype(np.float32)
    x = rng.normal(0, 1, (3, 5)).astype(np.float32)
    y[0, :2] = 0.0
    x[0, :2] = 0.0                            # atan2 at (0, 0)
    _check(JG.safe_atan2, TG.safe_atan2, [y, x], [0, 1])
    _check(JG.wrap_angle, TG.wrap_angle, [4 * y], [0])
    a, b = rng.normal(0, 2, (2, 6, 3)).astype(np.float32)
    b[1] = a[1]                               # coincident points
    _check(JG.pairwise_distances, TG.pairwise_distances, [a, b], [0, 1])
    p, q, r = rng.normal(0, 1.5, (3, 7, 3)).astype(np.float32)
    r[2] = 2 * q[2] - p[2]                    # collinear (180 degrees)
    p[3] = q[3]                               # zero-length arm
    _check(JG.angle_cos, TG.angle_cos, [p, q, r], [0, 1, 2])
    m = (rng.uniform(size=(3, 5)) > 0.3).astype(np.float32)
    _check(lambda v, mm: JG.masked_mean(v, mm, axis=1),
           lambda v, mm: TG.masked_mean(v, mm, dim=1), [x, m], [0])
    _check(lambda v, mm: JG.masked_mean(v, mm, eps=1e-8),
           lambda v, mm: TG.masked_mean(v, mm, eps=1e-8), [x, m], [0])


def test_huber_and_sequence_terms():
    rng = np.random.default_rng(9)
    x = rng.normal(0, 0.3, (4, 9)).astype(np.float32)
    _check(lambda v: JL.huber(v, 0.2), lambda v: TL.huber(v, 0.2), [x], [0])
    logits = rng.normal(0, 2, (B, L, 20)).astype(np.float32)
    labels = rng.integers(0, 20, (B, L)).astype(np.int32)
    mask = _backbone()[3]
    _check(JL.sequence_classification_loss, TL.sequence_classification_loss,
           [logits, labels, mask], [0])
    got = TL.sequence_accuracy(*(torch.from_numpy(v) for v in (logits, labels, mask)))
    want = JL.sequence_accuracy(logits, labels, mask)
    np.testing.assert_allclose(float(got), float(want), rtol=V_RTOL)


def _total_args(seed=11, degenerate=False):
    rng = np.random.default_rng(seed)
    n, ca, c, mask = _backbone(seed=seed, degenerate=degenerate)
    tn, tca, tc, _ = _backbone(seed=seed + 1)
    logits = rng.normal(0, 1, (B, L, 20)).astype(np.float32)
    labels = rng.integers(0, 20, (B, L)).astype(np.int32)
    mu_g, lv_g = rng.normal(0, 1, (2, B, 6)).astype(np.float32)
    mu_l, lv_l = rng.normal(0, 1, (2, B, L, 4)).astype(np.float32)
    tdih = _dihedrals(seed=seed + 2, zero_pairs=False)
    return [n, ca, c, logits, tn, tca, tc, labels, mask, mu_g, lv_g, mu_l,
            lv_l, tdih]


TOTAL_KEYS = {"total", "reconstruction", "reconstruction_ca",
              "reconstruction_n", "reconstruction_c", "pair_distance",
              "kl_global", "kl_local", "dihedral_consistency", "omega_trans",
              "ramachandran", "dihedral_total", "bond_length", "bond_angle",
              "sequence", "clash"}


@pytest.mark.parametrize("extra,degenerate", [
    ({}, False), ({}, True),
    ({"w_ca_spacing": 100.0, "w_clash_vdw": 3.0, "bond_delta": 25.0,
      "pair_stride": 4}, False)])
def test_compute_total_loss(extra, degenerate):
    args = _total_args(degenerate=degenerate)
    jw, tw = JWeights(**extra), TWeights(**extra)
    klw = (0.7, 0.3)
    jd = JL.compute_total_loss(*map(jnp.asarray, args), *klw, weights=jw,
                               use_pallas=False)
    targs = [torch.from_numpy(a.copy()) for a in args]
    td = TL.compute_total_loss(*targs, *klw, weights=tw)
    want_keys = set(TOTAL_KEYS)
    if extra:
        want_keys |= {"ca_spacing", "clash_vdw"}
    assert set(td) == set(jd) == want_keys
    for k in jd:
        np.testing.assert_allclose(float(td[k]), float(jd[k]), rtol=V_RTOL,
                                   atol=V_ATOL, err_msg=k)
    diff = [0, 1, 2, 3, 9, 10, 11, 12]        # predictions and posteriors
    _check(lambda *a: JL.compute_total_loss(*a, *klw, weights=jw,
                                            use_pallas=False)["total"],
           lambda *a: TL.compute_total_loss(*a, *klw, weights=tw)["total"],
           args, diff)
