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

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from protein_ensemble_vae_torch.losses import (clash_loss,  # noqa: E402
                                               compute_total_loss)
from protein_ensemble_vae_torch.ops.kernels import LAUNCHES  # noqa: E402
from protein_ensemble_vae_torch.ops.kernels.clash import (  # noqa: E402
    backbone_atoms, clash_fwd, clash_loss_kernel, pair_count)
from protein_ensemble_vae_tpu.losses import clash_loss as jax_clash_dense  # noqa: E402
from protein_ensemble_vae_tpu.ops.pallas.clash import (  # noqa: E402
    _pair_count as jax_pair_count, clash_loss_pallas)

RTOL, G_ATOL = 1e-3, 1e-6


def _batch(seed, B=2, L=40, holes=True, crowd=1.0):
    rng = np.random.default_rng(seed)
    n, ca, c = (crowd * rng.normal(0, 4, (B, L, 3)).astype(np.float32)
                for _ in range(3))
    mask = np.ones((B, L), np.float32)
    if holes:
        mask[0, -6:] = 0.0
        mask[1, 7] = 0.0
    return n, ca, c, mask


CASES = {"holes": dict(seed=0), "crowded": dict(seed=1, crowd=0.3),
         "L37": dict(seed=2, B=1, L=37, holes=False, crowd=0.5)}


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
    atoms, amask = backbone_atoms(n, ca, c, mask)
    assert clash_fwd(atoms.contiguous(), amask.contiguous()).shape == (2,)
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
