"""The port's eval geometry against pemp_tpu.geometry, exactly: the
short-side and the Hourglass's long-side multi-scale sizing, the affine
transforms, the host warp and the reverse map to image coordinates."""

import numpy as np
import pytest

from pemp_tpu import geometry as jgeo
from pemp_tpu_torch.config import get_config
from pemp_tpu_torch.geometry import affine, warp

SIZES = [(480, 640), (640, 427), (97, 131), (64, 64)]


@pytest.mark.parametrize("hw", SIZES, ids=str)
@pytest.mark.parametrize("scale,min_scale", [(1.0, 1.0), (2.0, 0.5), (0.5, 0.5), (1.0, 0.5)])
def test_multi_scale_size_and_transform(hw, scale, min_scale):
    h, w = hw
    for input_size in (512, 640):
        got = affine.get_multi_scale_size(h, w, input_size, scale, min_scale)
        want = jgeo.get_multi_scale_size(h, w, input_size, scale, min_scale)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        for inv in (False, True):
            np.testing.assert_array_equal(
                affine.get_affine_transform(got[1], got[2], got[0], inv=inv),
                jgeo.get_affine_transform(want[1], want[2], want[0], inv=inv))


@pytest.mark.parametrize("hw", SIZES[2:], ids=str)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_warp_affine(hw, dtype):
    rng = np.random.RandomState(0)
    image = (rng.rand(*hw, 3) * 255).astype(dtype)
    for s in (2.0, 1.0, 0.5):
        size, center, sc = affine.get_multi_scale_size(*hw, 64, s, 0.5)
        mat = affine.get_affine_transform(center, sc, size)
        got = warp.warp_affine(image.astype(np.float32), mat, size)
        assert got.shape == (size[1], size[0], 3)
        np.testing.assert_array_equal(got, jgeo.warp_affine(image.astype(np.float32), mat, size))
    gray = image[..., 0].astype(np.float32)
    np.testing.assert_array_equal(warp.warp_affine(gray, mat, size),
                                  jgeo.warp_affine(gray, mat, size))


@pytest.mark.parametrize("scaling_type",
                         ["short", "short_with_resize", "long", "long_with_multiscale"])
@pytest.mark.parametrize("min_scale", [1.0, 0.5])
def test_reverse_affine_map(scaling_type, min_scale):
    rng = np.random.RandomState(1)
    kp = rng.rand(3, 17, 3).astype(np.float32) * 300
    for size in ((640, 480), (427, 640)):
        got = affine.reverse_affine_map(kp.copy(), size, 512, scaling_type, min_scale)
        want = jgeo.reverse_affine_map(kp.copy(), size, 512, scaling_type, min_scale)
        np.testing.assert_array_equal(got, want)


def test_scaling_type_and_refusals():
    cfg = get_config()
    cfg.TEST.SCALE_FACTOR = [1.0]
    for p2i, want in ((True, "short_with_resize"), (False, "short")):
        cfg.TEST.PROJECT2IMAGE = p2i
        assert affine.get_scaling_type(cfg) == want == jgeo.get_scaling_type(cfg)
    cfg.TEST.SCALE_FACTOR = [1.0, 2.0]
    with pytest.raises(ValueError, match="PROJECT2IMAGE"):
        affine.get_scaling_type(cfg)
    # long-side scaling aggregates at score-map resolution (the JAX
    # package asserts it) and maps back only at input size 512
    cfg.DATASET.SCALING_TYPE = "long"
    cfg.TEST.PROJECT2IMAGE = True
    with pytest.raises(ValueError, match="PROJECT2IMAGE"):
        affine.get_scaling_type(cfg)
    cfg.TEST.PROJECT2IMAGE = False
    for scales, want in (([1.0, 2.0], "long_with_multiscale"), ([1.0], "long")):
        cfg.TEST.SCALE_FACTOR = scales
        assert affine.get_scaling_type(cfg) == want == jgeo.get_scaling_type(cfg)
    with pytest.raises(NotImplementedError, match="512"):
        affine.reverse_affine_map(np.zeros((1, 17, 3)), (64, 64), 256, "long")
    with pytest.raises(NotImplementedError, match="short_mine"):
        affine.reverse_affine_map(np.zeros((1, 17, 3)), (64, 64), 512, "short_mine")


@pytest.mark.parametrize("hw", SIZES, ids=str)
@pytest.mark.parametrize("scale,min_scale", [(1.0, 1.0), (2.0, 0.5), (0.5, 0.5)])
def test_multi_scale_size_hourglass(hw, scale, min_scale):
    """The long-side sizing and its transform, exactly."""
    got = affine.get_multi_scale_size_hourglass(*hw, 512, scale, min_scale)
    want = jgeo.get_multi_scale_size_hourglass(*hw, 512, scale, min_scale)
    assert got[0] == want[0] and got[0][0] == got[0][1]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(affine.get_affine_transform(got[1], got[2], got[0]),
                                  jgeo.get_affine_transform(want[1], want[2], want[0]))
