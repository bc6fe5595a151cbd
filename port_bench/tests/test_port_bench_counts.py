"""The frozen operation and byte counts against hand counts at tiny shapes."""

from __future__ import annotations

import pytest

from port_bench import counts
from port_bench.peaks import PEAK_BYTES_PER_S, PEAK_TF32_FLOPS


@pytest.mark.parametrize("n,W,want", [(1, 40, 0), (2, 40, 2), (5, 40, 20), (5, 2, 14),
                                      (6, 1, 10)])
def test_band_edges_by_hand(n, W, want):
    # pairs i != j with |i - j| <= W, counted one by one
    assert counts.band_edges(n, W) == want == sum(
        1 for i in range(n) for j in range(n) if i != j and abs(i - j) <= W)


def test_band_launches_by_hand():
    B, L, hd, edges = 2, 3, 4, 10
    ops, nbytes = counts.band_fwd_launch(B, L, hd, edges)
    assert ops == 10 * (4 * 16 + 8)
    assert nbytes == 4 * (48 + 18 + 6 + 32 + 16 + 1 + 24 + 18)
    ops, nbytes = counts.band_bwd_launch(B, L, hd, edges)
    assert ops == 10 * (12 * 16 + 80)
    assert nbytes == 4 * (96 + 24 + 36 + 6 + 32 + 16 + 1 + 18 + 32 + 16 + 1)


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(PEAK_TF32_FLOPS, 0) == 1.0
    assert counts.least_seconds(0, PEAK_BYTES_PER_S * 2) == 2.0


def test_model_flops_by_hand():
    cfg = dict(d_model=8, ff=16, nlayers=1, z_global=4, z_local=2, seqemb_dim=4,
               decoder_hidden=4, decoder_layers=1, max_neighbors=1, nhead=2)
    n = 3
    enc = (2 * n * (9 * 2 + 6 * 2 + 4 * 4 + 64)            # projections, fusion
           + 2 * (4 * 2 * n * 64 + 2 * 2 * n * n * 8)      # geometric attention + layer attention
           + 2 * 2 * n * 8 * 16                            # FFN
           + 2 * 2 * 64 + 2 * 2 * n * 64 + 2 * 2 * n * 8   # pooled attention
           + 2 * 8 * 256 + 2 * 256 * 8                     # global head
           + 2 * n * 8 * 256 + 2 * n * 256 * 4)            # local head
    dec = (2 * n * (6 * 4 + 4 * 2 + 2 * 3 + 6 * 4)
           + 2 * 2 * n * 16 + 2 * n * 8 * 4 + 2 * n * 16   # a_i, b_j, phi_h1, phi_h2
           + 4 * (4 * 16 + 8)                              # 4 band edges
           + 2 * n * (4 * 8 + 8 * 4 + 4 * 20)
           + 2 * 2 * n * (4 * 2 + 2 * 4))
    assert counts.encoder_flops(cfg, n) == enc
    assert counts.decoder_flops(cfg, n) == dec
    assert counts.train_step_flops(cfg, [n, n]) == 6 * (enc + dec)
