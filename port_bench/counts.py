"""Operations and bytes of the port's work, counted from shapes and valid
masks (frozen here, so a later change to the port cannot move them).

- Band kernels 1-2 (the EGNN band forward and backward, one launch per
  decoder layer): per valid band edge 4 Hd^2 + 2 Hd FLOP forward and
  12 Hd^2 + 20 Hd backward; bytes are each input read once and each output
  written once, fp32. The least time of a launch is the larger of its FLOP
  over the TF32 peak (3xTF32 counts once) and its bytes over the HBM rate.
- The model's FLOP: every product of the encoder, the latent heads and the
  decoder at each sample's valid length, attention over valid keys only,
  the band edges that the masks leave valid, and no recomputation; a train
  step is three times the forward (the backward takes two products per
  forward product). Elementwise work and the losses are left out, so the
  count is a floor of the work done.
"""

from __future__ import annotations

from port_bench.peaks import PEAK_BYTES_PER_S, PEAK_TF32_FLOPS


def band_edges(n: int, W: int) -> int:
    """Valid directed band edges of a chain of n valid residues: pairs
    0 < |i - j| <= W."""
    m = min(W, n - 1)
    return 2 * (m * n - m * (m + 1) // 2) if m > 0 else 0


def band_fwd_launch(B: int, L: int, hd: int, edges: int) -> tuple[int, int]:
    """(FLOP, bytes) of one kernel-1 launch on a [B, L] batch with
    ``edges`` valid edges at width ``hd``."""
    ops = edges * (4 * hd * hd + 2 * hd)
    nbytes = 4 * (2 * B * L * hd                     # a, bs
                  + B * L * 3 + B * L                # x, cmask
                  + 2 * hd * hd + 4 * hd + 1         # weights
                  + B * L * hd + B * L * 3)          # agg, raw_delta
    return ops, nbytes


def band_bwd_launch(B: int, L: int, hd: int, edges: int) -> tuple[int, int]:
    """(FLOP, bytes) of one kernel-2 launch (all of its passes)."""
    ops = edges * (12 * hd * hd + 20 * hd)
    nbytes = 4 * (4 * B * L * hd                                   # a, bs, da, dbs
                  + B * L * hd + 2 * B * L * 3 + B * L             # g_agg, x, g_delta, cmask
                  + 2 * hd * hd + 4 * hd + 1                       # weights
                  + B * L * 3 + 2 * hd * hd + 4 * hd + 1)          # dx, weight grads
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def encoder_flops(cfg: dict, n: int) -> int:
    """Forward FLOP of the encoder and latent heads on one chain of n
    valid residues."""
    d, ff, zg, zl = cfg["d_model"], cfg["ff"], cfg["z_global"], cfg["z_local"]
    f = 2 * n * (9 * (d // 4) + 6 * (d // 4) + cfg["seqemb_dim"] * (d // 2) + d * d)
    attn = 4 * 2 * n * d * d + 2 * 2 * n * n * d
    f += attn + cfg["nlayers"] * (attn + 2 * 2 * n * d * ff)
    f += 2 * 2 * d * d + 2 * 2 * n * d * d + 2 * 2 * n * d      # pooled attention, 1 query
    f += 2 * d * 256 + 2 * 256 * 2 * zg                          # global head
    f += 2 * n * d * 256 + 2 * n * 256 * 2 * zl                  # local head
    return f


def decoder_flops(cfg: dict, n: int) -> int:
    """Forward FLOP of the decoder on one chain of n valid residues."""
    hd, zc = cfg["decoder_hidden"], cfg["z_global"] + cfg["z_local"]
    f = 2 * n * (zc * hd + hd * (hd // 2) + (hd // 2) * 3 + zc * hd)
    layer = 2 * 2 * n * hd * hd + 2 * n * 2 * hd * hd + 2 * n * hd * hd
    f += cfg["decoder_layers"] * layer
    f += cfg["decoder_layers"] * band_edges(n, cfg["max_neighbors"]) * (4 * hd * hd + 2 * hd)
    f += 2 * n * (hd * 2 * hd + 2 * hd * hd + hd * 20)
    f += 2 * 2 * n * (hd * (hd // 2) + (hd // 2) * 4)
    return f


def train_step_flops(cfg: dict, lengths) -> int:
    """Model FLOP of one train step over chains of the given valid lengths."""
    return 3 * sum(encoder_flops(cfg, n) + decoder_flops(cfg, n) for n in lengths)
