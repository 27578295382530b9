"""The benchmark's frozen arithmetic: intervals, bounds, operation counts."""

import pytest
import torch

from mfbench import arith, harness


def test_overlapping_streams_count_once():
    # a kernel on the SLAM stream and one on the network's stream overlap
    slam = [(0.0, 10.0), (20.0, 30.0)]
    net = [(5.0, 25.0), (40.0, 41.0)]
    assert arith.merged(slam + net) == [(0.0, 30.0), (40.0, 41.0)]
    assert sum(e - s for s, e in arith.merged(slam + net)) == 31.0


@pytest.mark.parametrize("intervals, length", [
    ([], 0.0),
    ([(1.0, 1.0), (2.0, 1.0)], 0.0),            # empty and reversed
    ([(0.0, 4.0), (1.0, 2.0)], 4.0),            # nested
    ([(0.0, 1.0), (1.0, 2.0)], 2.0),            # touching
])
def test_union_length_edges(intervals, length):
    assert sum(e - s for s, e in arith.merged(intervals)) == length


def test_idle_gaps_between_busy_intervals():
    busy = arith.merged([(2.0, 3.0), (5.0, 6.0)])
    assert arith.gaps(busy, 0.0, 10.0) == [(0.0, 2.0), (3.0, 5.0),
                                            (6.0, 10.0)]
    assert arith.gaps(busy, 2.5, 5.5) == [(3.0, 5.0)]


def test_bilateral_bound_counts_taps_inside_the_image():
    # 3x3 image, radius 1: rows see 2, 3, 2 taps, columns the same
    rec = arith.bilateral_bound(3, 3, 1)
    assert rec["ops"] == arith.BILATERAL_OPS_PER_TAP * 7 * 7
    assert rec["bytes"] == 3 * 3 * 8
    vga = arith.bilateral_bound(480, 640, 6)
    assert vga["bound_by"] == "operations"
    assert vga["bound_ms"] == pytest.approx(vga["ops"] / 67e12 * 1e3)


def test_edge_bound_is_bytes_at_vga():
    rec = arith.edge_bound(480, 640, 478 * 638)
    assert rec["bytes"] == 480 * 640 * 28
    assert rec["ops"] == (8 * 17 + 3) * 478 * 638
    assert rec["bound_by"] == "bytes"
    assert rec["bound_ms"] == pytest.approx(480 * 640 * 28 / 3.35e12 * 1e3)


def test_network_macs_and_the_step():
    from mfbench.reference import maskrcnn as mm

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = mm.Conv(3, 4, 3)
            self.rpn = mm.Dense(8, 2)
            self.box_head = mm.ConvTranspose2x2(4, 2)
            self.mask_head = torch.nn.Identity()

    t = Tiny()
    for p in t.parameters():
        torch.nn.init.zeros_(p)

    def run():
        t.backbone(torch.zeros(1, 3, 5, 5))
        t.rpn(torch.zeros(6, 8))
        t.box_head(torch.zeros(1, 4, 3, 3))

    macs = arith.network_macs(t, run, (mm.Conv, mm.Dense,
                                       mm.ConvTranspose2x2))
    assert macs["backbone"] == 4 * 5 * 5 * 3 * 3 * 3
    assert macs["rpn"] == 6 * 2 * 8
    assert macs["box_head"] == 4 * 3 * 3 * 2 * 4
    assert macs["mask_head"] == 0
    assert arith.train_step_flops(1e9) == 6e9


def test_quantile_is_statistics_exclusive():
    xs = [float(i) for i in range(1, 21)]
    assert harness.quantile(xs, 9, 10) == pytest.approx(18.9)


def test_traced_counts_on_the_cpu():
    # on the CPU the trace has no device timeline: nothing is busy
    prof = harness.traced(lambda: torch.ones(64).sum(), 1, "cpu")
    assert prof["busy_us"] == 0.0 and prof["units"] == 1
    assert prof["window_us"] > 0
