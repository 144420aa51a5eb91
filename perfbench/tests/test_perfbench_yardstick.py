"""The frozen arithmetic: model FLOPs against hand counts, and the
convolution bound and peaks against chip_smoke.py's, where they were
copied from."""

import importlib.util

import pytest
from conftest import ROOT

from harness import peaks, spec

CONV2D_ROWS = spec.metric("conv2d_rows_roofline")


def _chip_smoke():
    s = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def test_vgg16_flops_match_the_hand_count():
    cfg = spec.cell("vgg16.b64.base").cfg
    trunk_macs = 15_346_630_656
    assert spec.reference("vgg16").flops_per_image(cfg) == \
        2 * (trunk_macs + 512 * 1000)


def test_resnet50_flops_match_the_hand_count():
    cfg = spec.cell("resnet50.b256.twophase_h8").cfg
    # stem 112² · 3·64·49; per stage (input size, cin, cmid, cout, blocks,
    # stride of the first)
    macs = 112 * 112 * 3 * 64 * 49
    for h, cin, cmid, cout, n, s in ((56, 64, 64, 256, 3, 1),
                                     (56, 256, 128, 512, 4, 2),
                                     (28, 512, 256, 1024, 6, 2),
                                     (14, 1024, 512, 2048, 3, 2)):
        ho = h // s
        macs += h * h * cin * cmid + ho * ho * (9 * cmid * cmid + cmid * cout
                                                + cin * cout)
        macs += (n - 1) * ho * ho * (2 * cout * cmid + 9 * cmid * cmid)
    macs += 2048 * 1000
    assert spec.reference("resnet50").flops_per_image(cfg) == 2 * macs
    assert 4.08e9 < macs < 4.12e9


def test_peaks_are_chip_smokes():
    cs = _chip_smoke()
    assert (peaks.PEAK_FP32_FLOPS, peaks.PEAK_TF32_FLOPS,
            peaks.PEAK_BF16_FLOPS, peaks.PEAK_HBM_BYTES) == (
        cs.PEAK_FP32_FLOPS, cs.PEAK_TF32_FLOPS, cs.PEAK_BF16_FLOPS,
        cs.PEAK_HBM_BYTES)


@pytest.mark.parametrize("batch", [32, 64])
def test_conv_bound_is_chip_smokes_at_vgg16_shapes(batch):
    cs = _chip_smoke()
    cfg = spec.cell("vgg16.b64.base").cfg
    convs = CONV2D_ROWS.convs(cfg, batch)
    assert len(convs) == 13
    shapes = [((h, w, cin, cout), 1) for _, h, w, cin, cout, *_ in convs]
    assert sorted({s for s, _ in shapes}) == sorted(
        s for s, _ in cs.VGG_SHAPES)
    for c in convs:
        assert peaks.bound_parts(*c) == cs._bound_parts(*c)
        assert peaks.bound(*peaks.bound_parts(*c)) == cs._bound(
            *cs._bound_parts(*c))
    stem = CONV2D_ROWS.convs(spec.cell("resnet50.b256.twophase_h8").cfg,
                             batch)
    assert peaks.bound_parts(*stem[0]) == cs._bound_parts(
        batch, 224, 224, 3, 64, k=7, s=2, p=3)
