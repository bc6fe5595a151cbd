"""Clash loss parity: the port's dense ``clash_loss`` and its kernel entry
``clash_loss_kernel`` (``ClashLossFunction``; on CPU tensors its wrappers
run the plain versions, so this checks the function's plumbing: pair
counts, gradient scale, un-interleaving) against the JAX package's blocked
``clash_loss_pallas`` (Pallas interpret mode on the CPU) and its dense
``clash_loss``. The CUDA kernels themselves are held against the plain
versions on the GPU by tests/test_torch_gpu.py and chip_smoke.py.

Tolerance: values and gradients rtol 1e-3, gradients atol 1e-6, as the JAX
package's own kernel tests (tests/test_pallas.py).
"""

import math
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from protein_ensemble_vae_torch.losses import (clash_loss,  # noqa: E402
                                               compute_total_loss)
from protein_ensemble_vae_torch.ops.kernels import LAUNCHES  # noqa: E402
from protein_ensemble_vae_torch.ops.kernels import clash as kclash  # noqa: E402
from protein_ensemble_vae_torch.ops.kernels.clash import (  # noqa: E402
    backbone_atoms, clash_bwd, clash_fwd, clash_loss_kernel, pair_count)
from protein_ensemble_vae_tpu.losses import clash_loss as jax_clash_dense  # noqa: E402
from protein_ensemble_vae_tpu.ops.pallas.clash import (  # noqa: E402
    _pair_count as jax_pair_count, clash_loss_pallas)

RTOL, G_ATOL = 1e-3, 1e-6


def _source_constants():
    """The tile, culling group and margins that csrc/clash.cu compiles, read
    from the source: the margin tests below check the kernels' own values."""
    from protein_ensemble_vae_torch.ops.kernels.build import CSRC_DIR

    with open(os.path.join(CSRC_DIR, "clash.cu")) as f:
        src = f.read()
    out = {}
    for name in ("TR", "GR", "SLOT", "REJECT_REL", "CULL_ABS", "CULL_REL"):
        m = re.search(rf"constexpr \w+ {name} = ([^;]+);", src)
        assert m is not None, name
        out[name] = m.group(1)
    return out


SRC = _source_constants()
REJECT_REL, CULL_ABS, CULL_REL = (float(SRC[k].rstrip("f")) for k in
                                  ("REJECT_REL", "CULL_ABS", "CULL_REL"))
GROUP = int(SRC["GR"])


def _batch(seed, B=2, L=40, holes=True, crowd=1.0, empty_row=None):
    rng = np.random.default_rng(seed)
    n, ca, c = (crowd * rng.normal(0, 4, (B, L, 3)).astype(np.float32)
                for _ in range(3))
    mask = np.ones((B, L), np.float32)
    if holes:
        mask[0, -6:] = 0.0
        mask[1, 7] = 0.0
    if empty_row is not None:
        mask[empty_row] = 0.0
    return n, ca, c, mask


CASES = {"holes": dict(seed=0), "crowded": dict(seed=1, crowd=0.3),
         "L37": dict(seed=2, B=1, L=37, holes=False, crowd=0.5),
         "all_masked_sample": dict(seed=5, B=3, L=45, crowd=0.5, empty_row=1)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    n, ca, c, mask = _batch(**CASES[request.param])
    jargs = [jnp.asarray(v) for v in (n, ca, c)]
    jm = jnp.asarray(mask)
    want = {}
    for name, fn in (("pallas", clash_loss_pallas), ("dense", jax_clash_dense)):
        val, grads = jax.value_and_grad(lambda *a: fn(*a, jm),
                                        argnums=(0, 1, 2))(*jargs)
        want[name] = (float(val), [np.asarray(g) for g in grads])
    return (n, ca, c, mask), want


@pytest.mark.parametrize("port", ["dense", "kernel_entry"])
@pytest.mark.parametrize("ref", ["pallas", "dense"])
def test_value_and_grad_parity(case, port, ref):
    (n, ca, c, mask), want = case
    ts = [torch.from_numpy(v.copy()).requires_grad_(True) for v in (n, ca, c)]
    fn = clash_loss if port == "dense" else clash_loss_kernel
    val = fn(*ts, torch.from_numpy(mask))
    val.backward()
    w_val, w_grads = want[ref]
    assert w_val > 0
    np.testing.assert_allclose(float(val.detach()), w_val, rtol=RTOL)
    for t, g in zip(ts, w_grads):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=RTOL, atol=G_ATOL)


def test_pair_count_matches_jax_and_dense_count():
    n, ca, c, mask = _batch(seed=3)
    got = pair_count(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_pair_count(jnp.asarray(mask))))
    atoms, amask = backbone_atoms(*(torch.from_numpy(v) for v in (n, ca, c, mask)))
    res = torch.arange(atoms.shape[1]) // 3
    pm = ((res[:, None] - res[None, :]).abs() >= 2).float().triu(1)
    dense = (amask[:, :, None] * amask[:, None, :] * pm).sum((1, 2))
    np.testing.assert_array_equal(got, dense.numpy())


def test_routing_on_cpu_tensors():
    """"auto" runs the dense clash on CPU tensors; True raises there; the
    kernel wrappers take their plain versions and count no launch."""
    n, ca, c, mask = (torch.from_numpy(v) for v in _batch(seed=4, crowd=0.3))
    before = (LAUNCHES["clash_fwd"], LAUNCHES["clash_bwd"])
    loss, totals, counts = clash_fwd(n, ca, c, mask)
    assert loss.shape == () and totals.shape == counts.shape == (2,)
    grads = clash_bwd(n, ca, c, mask, torch.tensor(1.0), counts)
    assert [tuple(d.shape) for d in grads] == [(2, 40, 3)] * 3
    z = torch.zeros(2, 6)
    args = (n, ca, c, torch.zeros(2, 40, 20), n, ca, c,
            torch.zeros(2, 40, dtype=torch.int32), mask, z, z,
            torch.zeros(2, 40, 4), torch.zeros(2, 40, 4), torch.zeros(2, 40, 6))
    from protein_ensemble_vae_torch.config import LossWeights

    d = compute_total_loss(*args, 1.0, 1.0, LossWeights(), use_pallas="auto")
    assert torch.equal(d["clash"], clash_loss(n, ca, c, mask))
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        compute_total_loss(*args, 1.0, 1.0, LossWeights(), use_pallas=True)
    assert (LAUNCHES["clash_fwd"], LAUNCHES["clash_bwd"]) == before


@pytest.mark.parametrize("ref", ["pallas", "dense"])
def test_wrapper_signatures_match_jax(case, ref):
    """``clash_fwd`` -> (loss, totals, counts) and ``clash_bwd`` (upstream
    gradient g, the forward's counts) -> (dn, dca, dc), through their plain
    versions on CPU tensors, against the JAX value and g x its gradients."""
    (n, ca, c, mask), want = case
    ts = [torch.from_numpy(v.copy()) for v in (n, ca, c, mask)]
    loss, totals, counts = clash_fwd(*ts)
    w_val, w_grads = want[ref]
    np.testing.assert_allclose(float(loss), w_val, rtol=RTOL)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(jax_pair_count(jnp.asarray(mask))))
    g = 0.8
    for d, w in zip(clash_bwd(*ts, torch.tensor(g), counts), w_grads):
        np.testing.assert_allclose(d.numpy(), g * w, rtol=RTOL, atol=G_ATOL)
    empty = mask.sum(1) == 0
    assert (totals.numpy()[empty] == 0).all() and (counts.numpy()[empty] == 0).all()


def _tile_pair_count(mask):
    """The forward kernel's pair count (``clash_fwd_kernel``) as a plain
    function: per pair of tiles I <= J, from the tiles' mask sums s = sum m,
    s2 = sum m^2 and a = sum m_r m_{r+1}: (s_I^2 - s2_I) / 2 - a_I on the
    diagonal, s_I s_J off it, less m_last(I) m_first(J) for neighbours;
    times 9."""
    B, L = mask.shape
    T = kclash.n_tiles(L)
    m = torch.nn.functional.pad(mask.to(torch.float32), (0, T * kclash.TILE - L))
    m = m.reshape(B, T, kclash.TILE)
    s, s2 = m.sum(-1), (m * m).sum(-1)
    adj = (m[..., :-1] * m[..., 1:]).sum(-1)
    diag = 0.5 * (s * s - s2) - adj
    off = torch.triu(s[:, :, None] * s[:, None, :], diagonal=1).sum((1, 2))
    seam = (m[:, :-1, -1] * m[:, 1:, 0]).sum(-1)
    return 9.0 * (diag.sum(-1) + off - seam)


@pytest.mark.parametrize("B,L", [(1, 37), (2, 64), (4, 230), (4, 256), (2, 640), (10, 640)])
def test_kernel_pair_count_formula_is_exact(B, L):
    """The forward kernel's count (per pair of tiles, from mask sums) equals
    ``pair_count`` and JAX's ``_pair_count`` bit for bit on 0/1 masks:
    holes, a masked tail, an all-masked and an all-valid sample."""
    rng = np.random.default_rng(B * 1000 + L)
    mask = (rng.random((B, L)) < 0.85).astype(np.float32)
    mask[0] = 1.0
    if B > 1:
        mask[1] = 0.0
    if B > 2:
        mask[2, L // 3:] = 0.0
    got = _tile_pair_count(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, pair_count(torch.from_numpy(mask)).numpy())
    np.testing.assert_array_equal(got, np.asarray(jax_pair_count(jnp.asarray(mask))))


MAIN_SHAPES = [(4, 256), (2, 640), (10, 256), (10, 640)]


def _residue_pairs(I, J, L, ordered):
    """Residue pairs a block of tiles (I, J) visits under the kernels'
    separation rule (forward: r_j - r_i >= 2; backward: |r_j - r_i| >= 2)."""
    T = kclash.TILE
    ri = np.arange(I * T, min(I * T + T, L))[:, None]
    rj = np.arange(J * T, min(J * T + T, L))[None, :]
    sep = rj - ri
    return int((np.abs(sep) >= 2).sum() if ordered else (sep >= 2).sum())


@pytest.mark.parametrize("B,L", MAIN_SHAPES + [(1, 37), (2, 64)])
def test_work_plan_covers_every_tile_pair(B, L):
    """The grids the wrappers size scratch for: one forward block per tile
    pair I <= J, which covers every residue pair >= 2 apart once, and one
    backward block per ordered tile pair, so each I tile owns all its
    pairs. At the main shapes both grids cover 132 SMs and no block holds
    more than 2x the mean work. (Which block takes which tile pair is the
    kernels' own; the GPU tests hold their sums against the plain
    versions.)"""
    T = kclash.n_tiles(L)
    P, gb = kclash.fwd_grid(B, L)
    assert gb == B
    pairs = [(I, J) for I in range(T) for J in range(I, T)]
    assert len(pairs) == P
    assert kclash.bwd_grid(B, L) == (T, T, B)
    fwd = np.array([_residue_pairs(I, J, L, False) for I, J in pairs])
    bwd = np.array([_residue_pairs(I, J, L, True) for I in range(T) for J in range(T)])
    assert fwd.sum() == (L - 1) * (L - 2) // 2 and bwd.sum() == 2 * fwd.sum()
    if (B, L) in MAIN_SHAPES:
        assert P * B >= 132 and T * T * B >= 132
        assert fwd.max() <= 2 * fwd.mean() and bwd.max() <= 2 * bwd.mean()


def _f32(x):
    return np.asarray(x, np.float32)


def _fma(a, b, c):
    return _f32(a.astype(np.float64) * b + c)


def _d2_variants(a, b):
    """|a - b|^2 as the kernel may compute it in fp32: left to right, or
    with the multiply-adds contracted."""
    d = _f32(a - b)
    plain = _f32(_f32(_f32(d[..., 0] * d[..., 0]) + _f32(d[..., 1] * d[..., 1]))
                 + _f32(d[..., 2] * d[..., 2]))
    fused = _fma(d[..., 2], d[..., 2], _fma(d[..., 1], d[..., 1], _f32(d[..., 0] * d[..., 0])))
    return plain, fused


def _plain_viol(a, b, clash_dist=kclash.CLASH_DIST):
    """viol of the plain version (``clash_pair_terms``), in fp32."""
    d = _f32(a - b)
    dist = np.sqrt(_f32(_f32(np.sum(d * d, axis=-1, dtype=np.float32)) + _f32(1e-12)))
    return np.maximum(_f32(clash_dist) - dist, 0)


@pytest.mark.parametrize("offset", [0.0, 100.0, 3000.0])
def test_rejection_drops_only_pairs_without_violation(offset):
    """Atom pairs 3.0-3.4 A apart at coordinates up to ``offset``: every
    pair with viol > 0 in the plain version passes the kernels' test
    d^2 < clash_dist^2 (1 + REJECT_REL), whichever way d^2 is rounded."""
    rng = np.random.default_rng(int(offset) + 1)
    a = _f32(offset + rng.normal(0, 10, (200_000, 3)))
    u = rng.normal(0, 1, (200_000, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    b = _f32(a + u * rng.uniform(3.0, 3.4, (200_000, 1)))
    viol = _plain_viol(a, b)
    cd = _f32(kclash.CLASH_DIST)
    cut2 = _f32(_f32(cd * cd) * _f32(1 + REJECT_REL))
    assert (viol > 0).sum() > 1000 and (viol[viol > 0] < 1e-3).any()
    for d2 in _d2_variants(a, b):
        assert (d2[viol > 0] < cut2).all()


def _group_sphere(atoms):
    """The kernel's bound of one group's valid atoms [n, 3] in fp32: box
    centre, radius (both roundings of d^2, the larger), box's largest
    |coordinate|."""
    lo, hi = atoms.min(0), atoms.max(0)
    cen = _f32(_f32(0.5) * _f32(lo + hi))
    r2 = np.maximum(*_d2_variants(atoms, cen[None])).max()
    return cen, _f32(np.sqrt(r2)), _f32(np.abs(np.concatenate([lo, hi])).max())


@pytest.mark.parametrize("offset", [0.0, 100.0, 3000.0])
def test_culling_keeps_every_violating_group_pair(offset):
    """Two culling groups (GR residues, 3 GR atoms) whose two extreme atoms face each
    other across 3.2 A +- 1e-3: whenever the plain version finds a pair with
    viol > 0 between them, the kernels' sphere test keeps the group pair."""
    rng = np.random.default_rng(int(offset) + 7)
    cd = kclash.CLASH_DIST
    kept_with_viol = 0
    for _ in range(3000):
        u = rng.normal(0, 1, 3)
        u /= np.linalg.norm(u)
        R = rng.uniform(2.0, 9.0)
        ci = offset + rng.normal(0, 20, 3)
        cj = ci + u * (2 * R + cd + rng.uniform(-1e-3, 1e-3))
        gi = ci + rng.normal(0, R / 3, (3 * GROUP, 3)) * 0.5
        gj = cj + rng.normal(0, R / 3, (3 * GROUP, 3)) * 0.5
        gi[0], gj[0] = ci + u * R, cj - u * R
        gi, gj = _f32(gi), _f32(gj)
        if not (_plain_viol(gi[:, None], gj[None]) > 0).any():
            continue
        (si, ri, ki), (sj, rj, kj) = _group_sphere(gi), _group_sphere(gj)
        lim = _f32(_f32(_f32(_f32(ri + rj) + _f32(cd)) + _f32(CULL_ABS))
                   + _f32(_f32(CULL_REL) * _f32(ki + kj)))
        for dc2 in _d2_variants(si, sj):
            assert not dc2 > _f32(lim * lim)
        kept_with_viol += 1
    assert kept_with_viol > 100


def test_kernel_constants_match_the_source():
    """The tile and partial size the wrappers allocate by are the ones
    csrc/clash.cu compiles, and the margins the tests above read from it
    are small and positive."""
    assert int(SRC["TR"]) == kclash.TILE
    assert SRC["SLOT"] == "9 * TR" and kclash.SLOT == 9 * kclash.TILE
    assert kclash.TILE % GROUP == 0
    assert 0 < REJECT_REL <= 1e-4 and 0 < CULL_ABS <= 1e-3 and 0 < CULL_REL <= 1e-4


@pytest.mark.parametrize("B,L,want", [(4, 256, (4, 4)), (2, 640, (2, 1)),
                                      (10, 256, (2, 1)), (10, 640, (1, 1))])
def test_block_split_at_the_main_shapes(B, L, want):
    """Warps per J group (forward, backward) at the main shapes: the split
    the sweep of scripts/clash_kernels_ab.py found fastest on the H100, and
    blocks x split within SPLIT_BUDGET wherever split > 1."""
    fblocks, bblocks = math.prod(kclash.fwd_grid(B, L)), math.prod(kclash.bwd_grid(B, L))
    got = (kclash.block_split(fblocks), kclash.block_split(bblocks))
    assert got == want
    for blocks, split in zip((fblocks, bblocks), got):
        assert split == 1 or blocks * split <= kclash.SPLIT_BUDGET
