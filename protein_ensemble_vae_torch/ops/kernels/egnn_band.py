"""EGNN band message passing: the CUDA kernels ``csrc/egnn_band_fwd.cu`` and
``csrc/egnn_band_bwd.cu``, their wrappers, their plain PyTorch versions, and
``EGNNBandFunction``, the autograd function that joins them.

Counterpart of the JAX package's ``ops/pallas/egnn_band.py``
(``egnn_band_fused`` with its custom VJP). Algebra, for receiver i and
offset k (j = i+k-W):

    pre[i,k] = a[i] + bs[j] + |x_i - x_j|^2 * w_d
    m  = silu(silu(pre) @ W_e2 + b_e2)
    agg[i]       = sum_k m * valid(i,k)
    raw_delta[i] = sum_k (silu(m @ W_x1 + b_x1) @ w_x2 + b_x2) * valid * rel

valid(i,k) = in-range & k != W & cmask_i & cmask_j; callers apply
deg_inv * 0.2 to raw_delta. The gradient takes no derivative through
``cmask`` (a mask) and ``W``.

Modes, as the JAX function's arguments:
- ``a`` / ``bs`` in fp32 or bf16 (a bf16 model's projections). The kernels
  read bf16 as it lies and widen it in registers; the plain version upcasts
  it. ``agg`` and ``raw_delta`` are fp32 in every mode, and the gradients
  of ``a`` / ``bs`` come back in their dtype.
- ``precision``: ``"highest"`` (JAX ``Precision.HIGHEST``, an fp32 model):
  the kernels' products in 3xTF32, fp32 accuracy; ``"default"`` (JAX
  ``None``, a bf16 model): one TF32 pass, the backend's fast product.
  The plain version computes in full fp32 in both (as JAX's ``None`` does
  on the CPU).
- ``chain_dtype``: fp32, or bf16 (JAX ``chain_dtype=jnp.bfloat16``): the
  edge MLP's activations and the cotangent chain in bf16, rounded where
  the JAX kernel rounds them (after every elementwise op; each product's
  fp32 sum rounded once), with bf16 weights (cast once per call) and bf16
  tensor-core products on the card; ``d2``, ``agg`` / ``raw_delta`` and
  every gradient sum stay fp32. ``precision`` selects nothing in this mode
  (bf16 operands give JAX's ``HIGHEST`` and ``None`` the same product) but
  must be one of the two. The plain version follows the JAX kernel op by
  op (``_bf16_chain_edges``, ``_bf16_chain_backward``); no JAX model path
  uses this mode, and the port's decoder does not either.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from protein_ensemble_vae_torch.ops.kernels import BAND_MODE_LAUNCHES, LAUNCHES
from protein_ensemble_vae_torch.ops.routing import pallas_policy
from protein_ensemble_vae_torch.parallel.shard import copy_to_tp, reduce_from_tp

Tensor = torch.Tensor

KERNEL = "egnn_band_fwd"
BWD_KERNEL = "egnn_band_bwd"
SUPPORTED_HIDDEN = (32, 64, 128, 256)
INPUT_DTYPES = (torch.float32, torch.bfloat16)   # of a and bs
CHAIN_DTYPES = (torch.float32, torch.bfloat16)   # of the edge chain
PASSES = {"highest": 3, "default": 1}   # precision -> TF32 passes per product (fp32 chain)
TILE = 8                  # receivers per tile (csrc/egnn_tile.cuh: T)
OPS = 8                   # band offsets per step (csrc/egnn_tile.cuh: OPS)
WGRAD_TILE = 128          # weight-grad output tile edge (csrc/egnn_band_bwd.cu)
FWD_WAVES = 8             # waves of resident blocks kernel 1's grid should span

_FN = None
_BWD_FN = None
_SM_COUNT: dict = {}
_PER_SM: dict = {}


def band_work(B: int, L: int, W: int) -> tuple[int, int, int]:
    """(receiver tiles per batch row, offset steps, work items): a work item
    of both kernels is one 64-edge step (batch row, tile of TILE receivers,
    OPS of the 2W band offsets)."""
    n_tiles = -(-L // TILE)
    n_steps = -(-2 * W // OPS)
    return n_tiles, n_steps, B * n_tiles * n_steps


def fwd_slices(B: int, L: int, W: int, n_sm: int, per_sm: int = 2) -> int:
    """Slices S of the band offsets for kernel 1: each of its B x tiles x S
    blocks walks ceil(steps / S) steps, and a second pass sums the S
    partial outputs in slice order. The grid should span FWD_WAVES waves of
    the ``n_sm * per_sm`` resident blocks, so that the last, partly filled
    wave costs little: S = 1 where B x tiles blocks already do; otherwise
    the most steps per block that still give that many blocks (one step
    per block at the least)."""
    n_tiles, n_steps, _ = band_work(B, L, W)
    blocks = B * n_tiles
    want = FWD_WAVES * n_sm * max(1, per_sm)
    if blocks >= want:
        return 1
    per = max(1, n_steps * blocks // want)
    return -(-n_steps // per)


def bwd_grid(B: int, L: int, W: int, Hd: int, n_sm: int,
             per_sm: int = 2) -> tuple[int, int]:
    """Kernel 2's grid: G persistent edge-pass blocks, one per resident slot
    (``per_sm`` blocks on each of ``n_sm`` SMs; block g takes work items g,
    g + G, ...), and the weight-grad pass's slices of the items, enough for
    its 2 x (Hd / tile)^2 output tiles to fill two slots per SM (the pass
    holds two blocks per SM)."""
    _, _, items = band_work(B, L, W)
    out_tiles = 2 * (Hd // min(Hd, WGRAD_TILE)) ** 2
    return (max(1, min(items, n_sm * max(1, per_sm))),
            max(1, min(items, -(-2 * n_sm // out_tiles))))


def _sm_count(dev) -> int:
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SM_COUNT[dev]


def band_indices(L: int, W: int, device=None) -> tuple[Tensor, Tensor]:
    """Static band geometry: neighbor indices [L, K] (clipped) and the
    in-range/non-self mask [L, K], K = 2W+1."""
    offs = torch.arange(2 * W + 1, device=device) - W
    base = torch.arange(L, device=device)[:, None] + offs[None, :]
    idx = base.clamp(0, L - 1)
    in_range = (base >= 0) & (base < L) & (offs != 0)[None, :]
    return idx, in_range


def band_gather(v: Tensor, idx: Tensor) -> Tensor:
    """Gather neighbors along the band: v [B, L, D], idx [L, K] -> [B, L, K, D]."""
    return v[:, idx]


def check_mode(precision: str, chain_dtype=torch.float32) -> None:
    """Raise unless (precision, chain_dtype) is a mode of the kernels."""
    if precision not in PASSES:
        raise ValueError(f"precision {precision!r}: expected one of {tuple(PASSES)}")
    if chain_dtype not in CHAIN_DTYPES:
        raise ValueError(f"chain_dtype={chain_dtype}: the band kernels' edge chain is "
                         f"one of {CHAIN_DTYPES}")


def _chain_bf16(chain_dtype) -> int:
    return int(chain_dtype == torch.bfloat16)


def band_chain(a, bs, x, nbr_idx, valid, w_d, w_e2, b_e2, w_x1, b_x1, w_x2,
               b_x2, dtype: torch.dtype, tp=None) -> tuple[Tensor, Tensor]:
    """The band-gather formulation, materialising the [B, L, K, Hd] edge
    tensors, with the edge chain in ``dtype``: ``a``, ``bs``, the weights
    and the squared distances (computed in fp32) are cast to it, and
    ``raw_delta`` is summed in ``x``'s dtype. ``nbr_idx`` [L, K] and
    ``valid`` [B, L, K] as ``band_indices`` and the caller's masks give
    them. fp32 is the kernels' chain (``egnn_band_reference``); bf16 is a
    bf16 model's plain path, the JAX package's XLA band path at bf16.
    Under tensor parallelism (``tp``, a ``parallel.shard.TP``) ``a``, ``bs``,
    ``w_d``, ``w_x1`` and ``b_x1`` hold this rank's hidden columns and
    ``w_e2``, ``w_x2`` its rows; the products through ``w_e2`` and ``w_x2``
    are summed over the tp group before their biases.
    Returns (agg [B, L, Hd] in ``dtype``, raw_delta [B, L, 3])."""
    c = lambda t: t.to(dtype)  # noqa: E731
    mask_k = c(valid)[..., None]                                 # [B, L, K, 1]
    rel = x[:, :, None, :] - band_gather(x, nbr_idx)             # [B, L, K, 3]
    d2 = copy_to_tp(c(torch.sum(rel * rel, dim=-1, keepdim=True)), tp)
    pre = c(a)[:, :, None, :] + band_gather(c(bs), nbr_idx) + d2 * c(w_d).reshape(-1)
    m = F.silu(pre)
    m = F.silu(reduce_from_tp(m @ c(w_e2), tp) + c(b_e2).reshape(-1))
    agg = torch.sum(m * mask_k, dim=2)
    w = reduce_from_tp(F.silu(copy_to_tp(m, tp) @ c(w_x1) + c(b_x1).reshape(-1))
                       @ c(w_x2).reshape(-1, 1), tp) + c(b_x2).reshape(1)
    raw_delta = torch.sum((w * mask_k).to(x.dtype) * rel, dim=2)
    return agg, raw_delta


def egnn_band_reference(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2,
                        b_x2, W: int, chain_dtype=torch.float32) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version, same arguments and outputs as the kernel. The
    fp32 chain is ``band_chain`` in fp32 (bf16 ``a`` / ``bs`` upcast). The
    bf16 chain is ``_bf16_chain_edges``, the JAX kernel's rounding op by op;
    its gradient is ``_bf16_chain_backward`` (``_BF16ChainPlain``)."""
    if _chain_bf16(chain_dtype):
        return _BF16ChainPlain.apply(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1,
                                     w_x2, b_x2, W)
    idx, in_range = band_indices(a.shape[1], W, a.device)
    cm = cmask > 0.5
    valid = in_range[None] & cm[:, :, None] & cm[:, idx]
    return band_chain(a, bs, x, idx, valid, w_d, w_e2, b_e2, w_x1, b_x1, w_x2,
                      b_x2, torch.float32)


# ---- the bf16 chain's plain version --------------------------------------
# JAX's `_fwd_kernel` / `_edge_chain_cotangents` with cdt = bf16: torch's bf16
# ops compute in fp32 and round their result to bf16, as the JAX kernel's
# ops on bf16 arrays do, so each expression below rounds where JAX rounds.

def _bf16_sigmoid(x: Tensor) -> Tensor:
    one = x.new_ones(())
    return one / (one + torch.exp(-x))          # JAX `_sigmoid`


def _bf16_silu(x: Tensor) -> Tensor:
    return x * _bf16_sigmoid(x)                 # JAX `_silu`


def _bf16_dsilu(x: Tensor) -> Tensor:
    one = x.new_ones(())
    s = _bf16_sigmoid(x)
    return s * (one + x * (one - s))            # JAX `_dsilu`


def _bf16_mm(a: Tensor, b: Tensor) -> Tensor:
    """JAX `_mm` into bf16: bf16 operands, fp32 sums, rounded once."""
    return (a.float() @ b.float()).to(torch.bfloat16)


def _bf16_chain_edges(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                      W: int) -> dict:
    """The bf16 chain's forward on every band edge [B, L, K] (K = 2W+1):
    the weights cast to bf16 (JAX `_param_tuple`), a / bs cast to bf16,
    d2 summed in fp32 then cast. Returns the edge tensors the forward and
    the backward read: valid_f, rel, d2 (fp32), pre, m1, u, m, v, w1, wsc
    (bf16), the bf16 weights and the band indices."""
    bf = torch.bfloat16
    idx, in_range = band_indices(a.shape[1], W, a.device)
    cm = cmask > 0.5
    valid_f = (in_range[None] & cm[:, :, None] & cm[:, idx]).float()[..., None]
    w = dict(w_d=w_d.reshape(-1), w_e2=w_e2, b_e2=b_e2.reshape(-1), w_x1=w_x1,
             b_x1=b_x1.reshape(-1), w_x2=w_x2.reshape(-1, 1), b_x2=b_x2.reshape(1))
    w = {k: v.to(bf) for k, v in w.items()}
    xf = x.float()
    rel = xf[:, :, None, :] - band_gather(xf, idx)                # [B, L, K, 3]
    d2 = torch.sum(rel * rel, dim=-1, keepdim=True)
    pre = (a.to(bf)[:, :, None, :] + band_gather(bs.to(bf), idx)) + d2.to(bf) * w["w_d"]
    m1 = _bf16_silu(pre)
    u = _bf16_mm(m1, w["w_e2"]) + w["b_e2"]
    m = _bf16_silu(u)
    v = _bf16_mm(m, w["w_x1"]) + w["b_x1"]
    w1 = _bf16_silu(v)
    wsc = _bf16_mm(w1, w["w_x2"]) + w["b_x2"]                     # [B, L, K, 1]
    return dict(valid_f=valid_f, rel=rel, d2=d2, pre=pre, m1=m1, u=u, m=m, v=v,
                w1=w1, wsc=wsc, w=w, idx=idx)


def _bf16_chain_forward(e: dict) -> tuple[Tensor, Tensor]:
    """(agg, raw_delta) from ``_bf16_chain_edges``: fp32 sums over the band
    of the masked bf16 messages and of wsc * rel."""
    valid = e["valid_f"].to(torch.bfloat16)
    agg = (e["m"] * valid).float().sum(dim=2)
    raw_delta = ((e["wsc"] * valid).float() * e["rel"]).sum(dim=2)
    return agg, raw_delta


def _bf16_chain_backward(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                         g_agg, g_delta, W: int) -> tuple[Tensor, ...]:
    """The bf16 chain's gradient as JAX's `_edge_chain_cotangents` rounds it:
    g_agg and cot_wsc cast to bf16, the cotangent chain in bf16 ops and
    products, cot_d2 and every sum over edges in fp32. Returns the gradients
    of (a, bs, x, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2), each shaped like
    its input, a / bs in their dtype, the rest fp32."""
    bf = torch.bfloat16
    e = _bf16_chain_edges(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2, W)
    w, idx, valid_f, rel = e["w"], e["idx"], e["valid_f"], e["rel"]
    valid = valid_f.to(bf)
    B, L, K = valid_f.shape[:3]
    gd = g_delta.float()[:, :, None, :]
    cot_wsc_f = torch.sum(gd * rel, dim=-1, keepdim=True) * valid_f
    cot_wsc = cot_wsc_f.to(bf)
    cot_w1 = _bf16_mm(cot_wsc, w["w_x2"].t())
    cot_v = cot_w1 * _bf16_dsilu(e["v"])
    cot_m = g_agg.to(bf)[:, :, None, :] * valid + _bf16_mm(cot_v, w["w_x1"].t())
    cot_u = cot_m * _bf16_dsilu(e["u"])
    cot_pre = _bf16_mm(cot_u, w["w_e2"].t()) * _bf16_dsilu(e["pre"])
    cot_d2 = torch.sum((cot_pre * w["w_d"]).float(), dim=-1, keepdim=True)
    d_rel = gd * (e["wsc"].float() * valid_f) + 2.0 * rel * cot_d2
    cp = cot_pre.float()

    def to_senders(t: Tensor) -> Tensor:
        """Sum edge values [B, L, K, D] onto their sender residues."""
        out = t.new_zeros((B, L, t.shape[-1]))
        return out.index_add_(1, idx.reshape(-1), t.reshape(B, L * K, -1))

    def outer(p: Tensor, q: Tensor) -> Tensor:
        """Sum over edges of p^T q (bf16 operands, fp32 sums)."""
        return p.float().reshape(-1, p.shape[-1]).t() @ q.float().reshape(-1, q.shape[-1])

    def vsum(t: Tensor) -> Tensor:
        return t.float().reshape(-1, t.shape[-1]).sum(dim=0)

    return (cp.sum(dim=2).to(a.dtype), to_senders(cp).to(bs.dtype),
            (d_rel.sum(dim=2) - to_senders(d_rel)).to(x.dtype),
            vsum(cp * e["d2"]).reshape(w_d.shape), outer(e["m1"], cot_u),
            vsum(cot_u).reshape(b_e2.shape), outer(e["m"], cot_v),
            vsum(cot_v).reshape(b_x1.shape), outer(e["w1"], cot_wsc).reshape(w_x2.shape),
            cot_wsc_f.sum().reshape(b_x2.shape))


class _BF16ChainPlain(torch.autograd.Function):
    """The bf16 chain's plain version with its plain gradient: forward
    ``_bf16_chain_edges``, backward ``_bf16_chain_backward`` (JAX's rounding
    points, not autograd through the rounded forward)."""

    @staticmethod
    def forward(ctx, a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2, W):
        ctx.W = W
        ctx.save_for_backward(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2)
        return _bf16_chain_forward(_bf16_chain_edges(a, bs, x, cmask, w_d, w_e2, b_e2,
                                                     w_x1, b_x1, w_x2, b_x2, W))

    @staticmethod
    @once_differentiable
    def backward(ctx, g_agg, g_delta):
        a, bs, x, cmask, *params = ctx.saved_tensors
        g_agg = torch.zeros(a.shape, device=a.device) if g_agg is None else g_agg
        g_delta = torch.zeros(x.shape, device=x.device) if g_delta is None else g_delta
        da, dbs, dx, *dparams = _bf16_chain_backward(a, bs, x, cmask, *params, g_agg,
                                                     g_delta, ctx.W)
        return (da, dbs, dx, None, *dparams, None)


def _kernel_fn():
    global _FN
    if _FN is None:
        from protein_ensemble_vae_torch.ops.kernels.build import load_library

        lib = load_library(KERNEL)
        fn = lib.egnn_band_fwd_launch
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.egnn_band_fwd_error_string.argtypes = [ctypes.c_int]
        lib.egnn_band_fwd_error_string.restype = ctypes.c_char_p
        lib.egnn_band_fwd_blocks_per_sm.argtypes = [ctypes.c_int] * 4
        lib.egnn_band_fwd_blocks_per_sm.restype = ctypes.c_int
        _FN = (fn, lib)
    return _FN


def _check(name: str, t: Tensor, shape: tuple, device,
           dtypes: tuple = (torch.float32,)) -> None:
    """Raise unless ``t`` is what the kernel reads: of one of ``dtypes``,
    contiguous, 16-byte aligned, on ``device``, of ``shape`` (a 1-D
    ``shape`` accepts any layout of that many elements, e.g. [1, Hd] or
    [Hd, 1]). Nothing is copied to make it so."""
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    ok = (t.numel() == shape[0]) if len(shape) == 1 else tuple(t.shape) == shape
    if not ok:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_inputs(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                  W: int) -> None:
    """Raise unless the band inputs are what both kernels take: a and bs
    of one dtype of INPUT_DTYPES, everything else fp32."""
    B, L, Hd = a.shape
    if Hd not in SUPPORTED_HIDDEN:
        raise ValueError(f"hidden width {Hd} not supported by the kernel "
                         f"(one of {SUPPORTED_HIDDEN})")
    if W < 1:
        raise ValueError(f"band half-width W={W} must be >= 1")
    if bs.dtype != a.dtype:
        raise ValueError(f"a and bs must share a dtype, got {a.dtype} and {bs.dtype}")
    for name, t, shape in (("a", a, (B, L, Hd)), ("bs", bs, (B, L, Hd))):
        _check(name, t, shape, a.device, INPUT_DTYPES)
    for name, t, shape in (
            ("x", x, (B, L, 3)), ("cmask", cmask, (B, L)), ("w_d", w_d, (Hd,)),
            ("w_e2", w_e2, (Hd, Hd)), ("b_e2", b_e2, (Hd,)),
            ("w_x1", w_x1, (Hd, Hd)), ("b_x1", b_x1, (Hd,)),
            ("w_x2", w_x2, (Hd,)), ("b_x2", b_x2, (1,))):
        _check(name, t, shape, a.device)


def mode_key(kernel: str, dtype: torch.dtype, precision: str,
             chain_dtype=torch.float32) -> str:
    """Key of a mode in ``BAND_MODE_LAUNCHES``:
    ``<kernel>:<dtype of a / bs>/<precision>`` in the fp32 chain,
    ``<kernel>:<dtype of a / bs>/bfloat16_chain`` in the bf16 chain, where
    ``precision`` selects nothing."""
    mode = "bfloat16_chain" if _chain_bf16(chain_dtype) else precision
    return f"{kernel}:{str(dtype).replace('torch.', '')}/{mode}"


def _count(kernel: str, dtype: torch.dtype, precision: str, chain_dtype) -> None:
    """One launch of ``kernel`` in the mode (dtype of a / bs, precision, chain)."""
    LAUNCHES[kernel] += 1
    key = mode_key(kernel, dtype, precision, chain_dtype)
    BAND_MODE_LAUNCHES[key] = BAND_MODE_LAUNCHES.get(key, 0) + 1


def egnn_band_fwd(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                  W: int, precision: str = "highest",
                  chain_dtype=torch.float32) -> tuple[Tensor, Tensor]:
    """The kernel's wrapper. For CPU tensors it is the plain version; for
    CUDA tensors it launches the kernel on the current stream or raises.

    a, bs [B, L, Hd], both fp32 or both bf16; x [B, L, 3]; cmask [B, L];
    w_d [1, Hd] or [Hd]; w_e2, w_x1 [Hd, Hd]; b_e2, b_x1 [Hd]; w_x2 [Hd, 1]
    or [Hd]; b_x2 [1]; all but a, bs fp32. ``precision`` and
    ``chain_dtype`` as in the module docstring. Returns (agg [B, L, Hd],
    raw_delta [B, L, 3]), fp32.
    """
    check_mode(precision, chain_dtype)
    if not a.is_cuda:
        return egnn_band_reference(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1,
                                   b_x1, w_x2, b_x2, W, chain_dtype)
    B, L, Hd = a.shape
    dev = a.device
    _check_inputs(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2, W)
    bf16, passes, cb = int(a.dtype == torch.bfloat16), PASSES[precision], _chain_bf16(chain_dtype)
    wts = _chain_weights(chain_dtype, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2)
    fn, lib = _kernel_fn()
    agg = torch.empty((B, L, Hd), dtype=torch.float32, device=dev)
    delta = torch.empty((B, L, 3), dtype=torch.float32, device=dev)
    if B == 0 or L == 0:
        return agg, delta
    S = fwd_plan(B, L, W, Hd, dev, a.dtype, precision, chain_dtype)
    # S > 1: each slice's partial outputs, summed in slice order by the
    # kernel's second pass
    parts = ((torch.empty((S, B, L, Hd), dtype=torch.float32, device=dev),
              torch.empty((S, B, L, 3), dtype=torch.float32, device=dev))
             if S > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a.data_ptr(), bs.data_ptr(), x.data_ptr(), cmask.data_ptr(),
                 *(t.data_ptr() for t in wts), agg.data_ptr(), delta.data_ptr(),
                 *((p.data_ptr() for p in parts) if parts else (None, None)),
                 B, L, Hd, W, S, bf16, passes, cb, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err} "
                           f"({lib.egnn_band_fwd_error_string(err).decode()})")
    _count(KERNEL, a.dtype, precision, chain_dtype)
    return agg, delta


def _chain_weights(chain_dtype, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                   transposed: bool = False) -> tuple[Tensor, ...]:
    """The weights as the kernels read them, (w_d, w_e2, b_e2, w_x1, b_x1,
    w_x2, b_x2) and with ``transposed`` also (W_e2^T, W_x1^T) row-major,
    which the backward's cotangent products stream. The fp32 chain reads
    them as given. The bf16 chain casts them to bf16 once per call (as
    JAX's `_param_tuple` does) into one buffer, in two device kernels (four
    with the transposes) rather than one per weight; each piece starts
    16-byte aligned, as Hd is a multiple of 8 and b_x2 comes last."""
    trans = (w_e2.t(), w_x1.t()) if transposed else ()
    if not _chain_bf16(chain_dtype):
        return (w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2) + tuple(t.contiguous() for t in trans)
    parts = (w_d, w_e2, b_e2, w_x1, b_x1, w_x2) + trans + (b_x2,)
    flat = torch.cat([t.reshape(-1) for t in parts]).to(torch.bfloat16)
    *pieces, b16 = flat.split([t.numel() for t in parts])
    return tuple(pieces[:6]) + (b16,) + tuple(pieces[6:])


def egnn_band_bwd_reference(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1,
                            w_x2, b_x2, g_agg, g_delta, W: int,
                            chain_dtype=torch.float32) -> tuple[Tensor, ...]:
    """Plain version of the backward: in the fp32 chain torch autograd
    through ``egnn_band_reference``, in the bf16 chain
    ``_bf16_chain_backward``. Returns the gradients of (a, bs, x, w_d,
    w_e2, b_e2, w_x1, b_x1, w_x2, b_x2), each shaped like its input and in
    its dtype."""
    if _chain_bf16(chain_dtype):
        return _bf16_chain_backward(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1,
                                    w_x2, b_x2, g_agg, g_delta, W)
    diff = [t.detach().requires_grad_(True)
            for t in (a, bs, x, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2)]
    with torch.enable_grad():
        a_, bs_, x_, *p = diff
        outs = egnn_band_reference(a_, bs_, x_, cmask, *p, W)
        return torch.autograd.grad(outs, diff, (g_agg, g_delta))


def _bwd_kernel_fn():
    global _BWD_FN
    if _BWD_FN is None:
        from protein_ensemble_vae_torch.ops.kernels.build import load_library

        lib = load_library(BWD_KERNEL)
        fn = lib.egnn_band_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.egnn_band_bwd_error_string.argtypes = [ctypes.c_int]
        lib.egnn_band_bwd_error_string.restype = ctypes.c_char_p
        lib.egnn_band_bwd_scratch_floats.argtypes = [ctypes.c_int] * 7
        lib.egnn_band_bwd_scratch_floats.restype = ctypes.c_size_t
        lib.egnn_band_bwd_blocks_per_sm.argtypes = [ctypes.c_int] * 4
        lib.egnn_band_bwd_blocks_per_sm.restype = ctypes.c_int
        _BWD_FN = (fn, lib)
    return _BWD_FN


def _blocks_per_sm(name: str, query, Hd: int, dev, dtype: torch.dtype,
                   precision: str, chain_dtype) -> int:
    """Blocks of kernel ``name`` in the mode (dtype of a / bs, precision,
    chain) at width Hd that one SM of ``dev`` holds, asked of its library
    once (``query``: its ``*_blocks_per_sm``)."""
    key = (name, Hd, dev, dtype, precision, chain_dtype)
    if key not in _PER_SM:
        with torch.cuda.device(dev):
            n = query(Hd, int(dtype == torch.bfloat16), PASSES[precision],
                      _chain_bf16(chain_dtype))
        if n < 1:
            raise RuntimeError(f"{name}: occupancy query failed (CUDA error "
                               f"{-n}) or no block fits on an SM")
        _PER_SM[key] = n
    return _PER_SM[key]


def fwd_plan(B: int, L: int, W: int, Hd: int, dev, dtype: torch.dtype = torch.float32,
             precision: str = "highest", chain_dtype=torch.float32) -> int:
    """``fwd_slices`` on CUDA device ``dev``: its SM count and the blocks
    of the mode that one SM holds."""
    per_sm = _blocks_per_sm(KERNEL, _kernel_fn()[1].egnn_band_fwd_blocks_per_sm, Hd, dev,
                            dtype, precision, chain_dtype)
    return fwd_slices(B, L, W, _sm_count(dev), per_sm)


def bwd_plan(B: int, L: int, W: int, Hd: int, dev, dtype: torch.dtype = torch.float32,
             precision: str = "highest", chain_dtype=torch.float32) -> tuple[int, int]:
    """``bwd_grid`` on CUDA device ``dev``: its SM count and the edge-pass
    blocks of the mode that one SM holds."""
    per_sm = _blocks_per_sm(BWD_KERNEL, _bwd_kernel_fn()[1].egnn_band_bwd_blocks_per_sm,
                            Hd, dev, dtype, precision, chain_dtype)
    return bwd_grid(B, L, W, Hd, _sm_count(dev), per_sm)


def egnn_band_bwd(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                  g_agg, g_delta, W: int, precision: str = "highest",
                  chain_dtype=torch.float32) -> tuple[Tensor, ...]:
    """The backward kernel's wrapper. For CPU tensors it is the plain
    version; for CUDA tensors it launches the kernel (four passes, one
    count) on the current stream or raises.

    Inputs as ``egnn_band_fwd`` plus the output cotangents g_agg [B, L, Hd]
    and g_delta [B, L, 3], fp32. Returns the gradients of (a, bs, x, w_d,
    w_e2, b_e2, w_x1, b_x1, w_x2, b_x2), each shaped like its input: those
    of a and bs in their dtype, the rest fp32. The kernel is deterministic:
    it sums across blocks in fixed order.
    """
    check_mode(precision, chain_dtype)
    if not a.is_cuda:
        return egnn_band_bwd_reference(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1,
                                       b_x1, w_x2, b_x2, g_agg, g_delta, W, chain_dtype)
    B, L, Hd = a.shape
    dev = a.device
    _check_inputs(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2, W)
    _check("g_agg", g_agg, (B, L, Hd), dev)
    _check("g_delta", g_delta, (B, L, 3), dev)
    fn, lib = _bwd_kernel_fn()
    f32 = dict(dtype=torch.float32, device=dev)
    alloc = torch.empty if B and L else torch.zeros
    da = alloc((B, L, Hd), dtype=a.dtype, device=dev)
    dbs = alloc((B, L, Hd), dtype=a.dtype, device=dev)
    dx = alloc((B, L, 3), **f32)
    dw_e2 = alloc((Hd, Hd), **f32)
    dw_x1 = alloc((Hd, Hd), **f32)
    dvec = alloc((4 * Hd + 1,), **f32)
    if B and L:
        cb = _chain_bf16(chain_dtype)
        G, nsplit = bwd_plan(B, L, W, Hd, dev, a.dtype, precision, chain_dtype)
        scratch = torch.empty(
            (lib.egnn_band_bwd_scratch_floats(B, L, Hd, W, G, nsplit, cb),), **f32)
        wts = _chain_weights(chain_dtype, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                             transposed=True)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*(t.data_ptr() for t in (
                a, bs, x, cmask, *wts, g_agg, g_delta, da, dbs, dx, dw_e2, dw_x1, dvec,
                scratch)), B, L, Hd, W, G, nsplit, int(a.dtype == torch.bfloat16),
                PASSES[precision], cb, stream)
        if err != 0:
            raise RuntimeError(f"{BWD_KERNEL} launch failed: CUDA error {err} "
                               f"({lib.egnn_band_bwd_error_string(err).decode()})")
        _count(BWD_KERNEL, a.dtype, precision, chain_dtype)
    dw_d, db_e2, db_x1, dw_x2 = dvec[:4 * Hd].view(4, Hd)
    return (da, dbs, dx, dw_d.reshape(w_d.shape), dw_e2,
            db_e2.reshape(b_e2.shape), dw_x1, db_x1.reshape(b_x1.shape),
            dw_x2.reshape(w_x2.shape), dvec[4 * Hd:].reshape(b_x2.shape))


class EGNNBandFunction(torch.autograd.Function):
    """Kernel 1 forward, kernel 2 backward. Like the JAX custom VJP it saves
    only the inputs (nothing of size K = 2W+1): the backward recomputes
    the edge chain."""

    @staticmethod
    def forward(ctx, a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2,
                b_x2, W, precision="highest", chain_dtype=torch.float32):
        ctx.W, ctx.precision, ctx.chain_dtype = W, precision, chain_dtype
        ctx.save_for_backward(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1,
                              w_x2, b_x2)
        return egnn_band_fwd(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1,
                             w_x2, b_x2, W, precision, chain_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_agg, g_delta):
        a, bs, x, cmask, *params = ctx.saved_tensors
        g_agg = (torch.zeros(a.shape, dtype=torch.float32, device=a.device)
                 if g_agg is None else g_agg.to(torch.float32).contiguous())
        g_delta = (torch.zeros_like(x) if g_delta is None
                   else g_delta.to(torch.float32).contiguous())
        da, dbs, dx, *dparams = egnn_band_bwd(a, bs, x, cmask, *params,
                                              g_agg, g_delta, ctx.W,
                                              ctx.precision, ctx.chain_dtype)
        return (da, dbs, dx, None, *dparams, None, None, None)


def egnn_band_fused(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                    W: int, use_pallas: object = "auto", precision: str = "highest",
                    chain_dtype=torch.float32) -> tuple[Tensor, Tensor]:
    """Routed entry of the decoder: ``EGNNBandFunction`` (kernel forward and
    backward) where ``pallas_policy`` says so (``ops/routing.py``), else the
    plain version, whose gradient is torch autograd (in the bf16 chain
    ``_bf16_chain_backward``, JAX's rounding points). ``precision`` and
    ``chain_dtype`` as in the module docstring (JAX ``egnn_band_fused``'s
    arguments of the same names)."""
    check_mode(precision, chain_dtype)
    if pallas_policy(a, use_pallas):
        return EGNNBandFunction.apply(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1,
                                      b_x1, w_x2, b_x2, W, precision, chain_dtype)
    return egnn_band_reference(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1,
                               w_x2, b_x2, W, chain_dtype)
