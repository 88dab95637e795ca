"""The benchmark's arithmetic on fixed inputs."""
import statistics

import pytest

from motbench import arith
from motbench.reference.detect import parse_cfg

ONE_CONV = """
[net]
width=8
height=8
channels=3

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[convolutional]
filters=6
size=1
stride=2
pad=1
activation=linear

[yolo]
mask=0
anchors=1,1
classes=1
"""


def test_flops_of_one_conv_by_hand():
    # 3x3, 3 -> 16 channels over 8 x 8 outputs, then 1x1/2, 16 -> 6 over
    # 4 x 4 outputs
    want = 8 * 8 * 16 * 3 * 3 * 3 + 4 * 4 * 6 * 16
    assert arith.detector_macs(parse_cfg(ONE_CONV), (8, 8)) == want


def test_network_flops_match_published_scale():
    """YOLOv4 at 512 x 512 is about 91 GFLOP (2 x MACs) a frame (Darknet
    prints 128 BFLOPs at 608 x 608; the count scales with the pixels);
    OSNet-x0.25 about 82.6 M multiply-adds a 256 x 128 crop (torchreid's
    model zoo table)."""
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    secs = parse_cfg((root / 'configs' / 'yolov4_osnet025.cfg').read_text())
    gflop = 2 * arith.detector_macs(secs, (512, 512)) / 1e9
    assert 85 < gflop < 95
    osnet = arith.osnet_macs((16, 64, 96, 128), 512, (256, 128)) / 1e6
    assert 80 < osnet < 85


def test_percentile_rate_and_spread():
    v = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert arith.percentile(v, 50) == 3.0
    assert arith.percentile(v, 95) == pytest.approx(4.8)
    assert arith.percentile(v, 0) == 1.0 and arith.percentile(v, 100) == 5.0
    assert arith.rate(600, 20.0) == 30.0
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert arith.quartile_spread(v) == pytest.approx((q3 - q1) / q2)
    with pytest.raises(ValueError):
        arith.rate(1, 0)


def test_busy_share_and_gaps():
    iv = [(0.0, 1.0), (0.5, 1.5), (3.0, 4.0), (3.2, 3.4)]
    assert arith.busy_seconds(iv) == pytest.approx(2.5)
    assert arith.idle_gaps(iv, 0.0, 5.0) == [(1.5, 3.0), (4.0, 5.0)]
    assert arith.busy_seconds([]) == 0.0


def test_osblock_bound_by_hand():
    """OSBlock 64 -> 64 (mid 16, gate hidden 1): packed weights are the
    twelve 1x1 matrices as bf16 with K padded to 16, and the rest as
    float32."""
    mats = 2 * (64 * 16 + 10 * 16 * 16 + 16 * 64)
    vecs = 4 * (2 * 16 + 10 * (9 * 16 + 2 * 16) + (16 + 1 + 16 + 16)
                + 2 * 64)
    assert arith.osblock_packed_bytes(64, 64) == mats + vecs
    ms = arith.osblock_bound_ms(1024, 64, 32, 64, 64)
    px = 1024 * 64 * 32
    bytes_ms = (px * 128 * 2 + mats + vecs) / arith.PEAK_BYTES * 1e3
    assert ms >= bytes_ms
    assert arith.osnet_block_shapes((16, 64, 96, 128), (256, 128)) == [
        (64, 32, 16, 64), (64, 32, 64, 64), (32, 16, 64, 96),
        (32, 16, 96, 96), (16, 8, 96, 128), (16, 8, 128, 128)]
