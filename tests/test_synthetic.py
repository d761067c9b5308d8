"""The seeded EuRoC-shaped stereo sequence and its dataset path."""

import sys

import numpy as np
import pytest

from photometric_bundle_adjustment_tpu.core import se3
from photometric_bundle_adjustment_tpu.io import calib_io, dataset
from photometric_bundle_adjustment_tpu.models import synthetic


def test_render_stereo_sequence_seeded():
    im_a, ts_a, poses_a = synthetic.render_stereo_sequence(0, n_frames=1)
    im_b, _, _ = synthetic.render_stereo_sequence(0, n_frames=1)
    im_c, _, _ = synthetic.render_stereo_sequence(1, n_frames=1)
    assert sorted(im_a) == [(0, 0), (0, 1)] and len(ts_a) == 1
    for k, img in im_a.items():
        assert img.shape == (480, 752) and img.dtype == np.uint8
        np.testing.assert_array_equal(img, im_b[k])
        assert np.mean(img != im_c[k]) > 0.5
        assert img.std() > 20.0          # textured, not flat
    assert sorted(poses_a) == sorted(im_a)


def test_render_stereo_sequence_extrinsic_matches_calibration():
    _, _, poses = synthetic.render_stereo_sequence(0, n_frames=2)
    calib = calib_io.load_calibration(synthetic.EUROC_CALIB)
    traj = synthetic.load_trajectory()
    for f in range(2):
        np.testing.assert_allclose(poses[(f, 0)], traj[(f, 0)], atol=1e-12)
        expect = se3.compose(
            se3.compose(np.asarray(poses[(f, 0)]),
                        se3.inverse(np.asarray(calib.T_i_c[0]))),
            np.asarray(calib.T_i_c[1]),
        )
        T01 = se3.compose(se3.inverse(np.asarray(poses[(f, 0)])),
                          np.asarray(poses[(f, 1)]))
        np.testing.assert_allclose(poses[(f, 1)], expect, atol=1e-9)
        assert abs(float(np.linalg.norm(T01[:3])) - 0.110) < 1e-3


def test_load_images_synthetic_path():
    images, ts = dataset.load_images("synthetic:0", max_frames=1)
    assert sorted(images) == [(0, 0), (0, 1)] and len(ts) == 1
    assert images[(0, 0)].shape == (480, 752)


def test_load_images_directory_without_pil_names_package(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        dataset.load_images(str(tmp_path))
