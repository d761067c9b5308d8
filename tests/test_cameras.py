"""Camera-model tests: project/unproject round trips on the reference's
hard-coded test intrinsics (camera_models.h getTestProjections) and
Jacobian sanity for the kb4 Newton inverse."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photometric_bundle_adjustment_tpu.core import camera_slab, cameras

MODELS = ["pinhole", "eucm", "ds", "kb4"]


def sample_points(n=200, fov_limit=0.8, seed=0):
    """Random 3D points in front of the camera within a cone."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.5, 10.0, size=n)
    r = z * np.tan(fov_limit) * rng.uniform(0, 1, size=n)
    ang = rng.uniform(0, 2 * np.pi, size=n)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang), z], axis=-1)
    return jnp.asarray(pts, jnp.float64)


@pytest.mark.parametrize("model", MODELS)
def test_project_unproject_roundtrip(model):
    params = cameras.test_params(model)
    pts = sample_points()
    bearings = pts / jnp.linalg.norm(pts, axis=-1, keepdims=True)
    uv = cameras.project(model, params, pts)
    back = cameras.unproject_unit(model, params, uv)
    np.testing.assert_allclose(np.asarray(back), np.asarray(bearings), atol=1e-9)


@pytest.mark.parametrize("model", MODELS)
def test_unproject_project_roundtrip(model):
    params = cameras.test_params(model)
    # pixels around the principal point
    cx, cy = float(params[2]), float(params[3])
    rng = np.random.default_rng(1)
    uv = jnp.asarray(
        np.stack([cx + rng.uniform(-200, 200, 100), cy + rng.uniform(-200, 200, 100)], -1),
        jnp.float64,
    )
    bearing = cameras.unproject_unit(model, params, uv)
    uv2 = cameras.project(model, params, bearing)
    np.testing.assert_allclose(np.asarray(uv2), np.asarray(uv), atol=1e-7)


@pytest.mark.parametrize("model", MODELS)
def test_projection_center_pixel(model):
    """A point on the optical axis projects to the principal point."""
    params = cameras.test_params(model)
    uv = cameras.project(model, params, jnp.array([0.0, 0.0, 2.0]))
    np.testing.assert_allclose(np.asarray(uv), np.asarray(params[2:4]), atol=1e-9)


@pytest.mark.parametrize("model", MODELS)
def test_jacobians_finite(model):
    params = cameras.test_params(model)
    pts = sample_points(20)
    Jp = jax.vmap(jax.jacfwd(lambda p: cameras.project(model, params, p)))(pts)
    assert bool(jnp.all(jnp.isfinite(Jp)))
    Ji = jax.vmap(
        jax.jacfwd(lambda prm, p: cameras.project(model, prm, p)), in_axes=(None, 0)
    )(params, pts)
    assert bool(jnp.all(jnp.isfinite(Ji)))
    # unproject jacobian wrt pixel (exercises the kb4 implicit-diff path)
    uv = cameras.project(model, params, pts)
    Ju = jax.vmap(jax.jacfwd(lambda q: cameras.unproject(model, params, q)))(uv)
    assert bool(jnp.all(jnp.isfinite(Ju)))


def test_kb4_implicit_diff_matches_fd():
    """kb4 unproject Jacobian via implicit diff vs. finite differences."""
    params = cameras.test_params("kb4")
    uv = jnp.array([600.0, 450.0])
    J = jax.jacfwd(lambda q: cameras.unproject("kb4", params, q))(uv)
    h = 1e-6
    for j in range(2):
        d = jnp.zeros(2).at[j].set(h)
        fd = (
            cameras.unproject("kb4", params, uv + d)
            - cameras.unproject("kb4", params, uv - d)
        ) / (2 * h)
        np.testing.assert_allclose(np.asarray(J[:, j]), np.asarray(fd), atol=1e-6)


def test_initialize_from_ds():
    ds = jnp.array([370.0, 370.0, 375.5, 239.5, 0.1, 0.5, 0.0, 0.0])
    p = cameras.initialize("pinhole", ds)
    np.testing.assert_allclose(np.asarray(p[4:]), 0.0)
    e = cameras.initialize("eucm", ds)
    assert float(e[4]) == 0.5 and float(e[5]) == 1.0
    d = cameras.initialize("ds", ds)
    np.testing.assert_allclose(np.asarray(d), np.asarray(ds))


@pytest.mark.parametrize("model", ["pinhole", "eucm", "ds", "kb4"])
def test_camera_slab_jacobian_matches_autodiff(model):
    rng = np.random.default_rng(3)
    N = 64
    pts = rng.normal(size=(N, 3))
    pts[:, 2] = np.abs(pts[:, 2]) + 0.5          # in front of the camera
    intr = np.asarray(cameras.test_params(model, jnp.float64))
    intr_slab = jnp.asarray(np.tile(intr[:, None], (1, N)))

    qx = jnp.asarray(pts[None, :, 0])            # (1, N) planes
    qy = jnp.asarray(pts[None, :, 1])
    qz = jnp.asarray(pts[None, :, 2])
    u, v, J0, J1 = camera_slab.project_slab(model, intr_slab, qx, qy, qz)

    ref_uv = np.asarray(cameras.project(model, jnp.asarray(intr),
                                        jnp.asarray(pts)))
    Jref = np.asarray(jax.vmap(
        jax.jacfwd(lambda p: cameras.project(model, jnp.asarray(intr), p))
    )(jnp.asarray(pts)))                         # (N, 2, 3)

    np.testing.assert_allclose(np.asarray(u)[0], ref_uv[:, 0], rtol=1e-10)
    np.testing.assert_allclose(np.asarray(v)[0], ref_uv[:, 1], rtol=1e-10)
    for c in range(3):
        np.testing.assert_allclose(
            np.asarray(J0[c])[0], Jref[:, 0, c], rtol=1e-7, atol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(J1[c])[0], Jref[:, 1, c], rtol=1e-7, atol=1e-9
        )
