"""Photometric BA test: multi-view images rendered from a textured plane
with known geometry and affine brightness; the solver must recover poses,
inverse depths, and affine parameters from a perturbed initialisation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photometric_bundle_adjustment_tpu.core import cameras, se3
from photometric_bundle_adjustment_tpu.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu.optim import ba

H, W = 96, 128
MODEL = "pinhole"
INTR = jnp.array([80.0, 80.0, W / 2, H / 2, 0, 0, 0, 0])
# curved world surface: sphere (closed-form ray intersection, depth varies
# across the image, so the pose/depth plane-gauge ambiguity is broken)
SPHERE_C = jnp.array([0.6, 0.0, 14.0])
SPHERE_R = 9.5


def texture(p_xy):
    """Smooth synthetic world texture: intensity as function of (x, y)."""
    x, y = p_xy[..., 0], p_xy[..., 1]
    return (
        120.0
        + 50.0 * jnp.sin(1.7 * x) * jnp.cos(2.3 * y)
        + 40.0 * jnp.sin(3.1 * x + 2.0 * y)
        + 15.0 * jnp.sin(7.3 * x) * jnp.sin(5.9 * y)
    )


def ray_depth(o, dw):
    """Distance along unit rays from origin o to the sphere (first hit)."""
    oc = o[None, :] - SPHERE_C[None, :]
    bq = jnp.sum(dw * oc, axis=-1)
    cq = jnp.sum(oc * oc, axis=-1) - SPHERE_R**2
    disc = jnp.sqrt(jnp.maximum(bq * bq - cq, 1e-9))
    return -bq - disc


def render(T_w_c, a=0.0, b=0.0):
    """Render the surface through a camera with affine brightness (a, b)."""
    ys, xs = jnp.mgrid[0:H, 0:W]
    uv = jnp.stack([xs.astype(jnp.float64), ys.astype(jnp.float64)], -1)
    d = cameras.unproject_unit(MODEL, INTR, uv.reshape(-1, 2))
    o = se3.translation(T_w_c)
    dw = se3.quat_rotate(se3.rotation(T_w_c), d)
    lam = ray_depth(o, dw)
    p_w = o[None, :] + lam[:, None] * dw
    I = texture(p_w[:, :2])
    return (jnp.exp(a) * I + b).reshape(H, W)


@pytest.fixture(scope="module")
def scene():
    K = 4
    rng = np.random.default_rng(0)
    xi = np.zeros((K, 6))
    xi[:, 0] = np.arange(K) * 0.4          # sideways baseline
    xi[:, 1] = rng.normal(0, 0.05, K)
    xi[:, 3:] = rng.normal(0, 0.01, (K, 3))
    xi[0] = 0
    poses_gt = se3.exp(jnp.asarray(xi))
    affine_gt = np.zeros((K, 2))
    affine_gt[2:, 0] = rng.uniform(-0.2, 0.2, K - 2)
    affine_gt[2:, 1] = rng.uniform(-10, 10, K - 2)
    images = jnp.stack(
        [render(poses_gt[k], *affine_gt[k]) for k in range(K)]
    )
    return poses_gt, jnp.asarray(affine_gt), images


def build_pba_problem(scene, L=80, seed=1):
    poses_gt, affine_gt, images = scene
    K = poses_gt.shape[0]
    rng = np.random.default_rng(seed)
    images_flat = images.reshape(-1)

    # landmarks anchored in camera 0 at random well-inside pixels
    uv_ref = np.stack(
        [rng.uniform(10, W - 10, L), rng.uniform(10, H - 10, L)], -1
    )
    d = cameras.unproject_unit(MODEL, INTR, jnp.asarray(uv_ref))
    o = se3.translation(poses_gt[0])
    dw = se3.quat_rotate(se3.rotation(poses_gt[0]), d)
    lam = ray_depth(o, dw)
    inv_depth_gt = 1.0 / lam  # ||d|| = 1, so depth along ray = lam

    ref_patch = pba.extract_ref_patches(
        images_flat, jnp.zeros(L, jnp.int32), jnp.asarray(uv_ref), H, W
    )

    # observations in cameras 1..K-1
    obs_a = np.tile(np.zeros(L, np.int32), K - 1)
    obs_c = np.concatenate([np.full(L, k, np.int32) for k in range(1, K)])
    obs_l = np.tile(np.arange(L, dtype=np.int32), K - 1)
    O = L * (K - 1)

    problem = pba.build_problem(
        poses=poses_gt,
        affine=affine_gt,
        inv_depth=jnp.asarray(inv_depth_gt),
        anchor_cam=obs_a,
        target_cam=obs_c,
        landmark=obs_l,
        uv_ref=jnp.tile(jnp.asarray(uv_ref), (K - 1, 1)),
        ref_patch=jnp.tile(ref_patch, (K - 1, 1)),
        target_img=obs_c,
        intr_ref=jnp.tile(INTR, (O, 1)),
        intr_target=jnp.tile(INTR, (O, 1)),
        valid=np.ones(O, bool),
        fixed_cams=np.arange(K) < 2,
    )
    return problem, images_flat, inv_depth_gt


def test_pba_zero_residual_at_ground_truth(scene):
    problem, images_flat, _ = build_pba_problem(scene)
    res_fn = pba.make_residual_fn(MODEL, images_flat, H, W)
    residual_cost, _ = ba.make_ba_step(res_fn, pba.cam_retract, 8)
    cfg = ba.BAConfig(huber_delta=-1.0)
    cost = float(residual_cost(problem, cfg))
    n = problem.obs.valid.shape[0] * pba.PATCH_SIZE
    rms = np.sqrt(2 * cost / n)
    # bilinear resampling noise + the DSO constant-depth-per-patch
    # approximation on the curved surface
    assert rms < 8.0, f"intensity RMS at GT = {rms}"


def test_pba_recovers_from_perturbation(scene):
    poses_gt, affine_gt, _ = scene
    problem, images_flat, inv_depth_gt = build_pba_problem(scene)
    rng = np.random.default_rng(7)
    K = poses_gt.shape[0]

    dpose = np.zeros((K, 6))
    dpose[2:] = rng.normal(0, 0.004, (K - 2, 6))
    cams0 = pba.PhotometricCams(
        pose=jax.vmap(se3.right_plus)(problem.cam_states.pose,
                                      jnp.asarray(dpose)),
        affine=problem.cam_states.affine
        + jnp.asarray(rng.normal(0, 0.02, (K, 2))).at[:2].set(0.0),
    )
    noisy = problem._replace(
        cam_states=cams0,
        inv_depth=problem.inv_depth * (1 + rng.normal(0, 0.02, len(inv_depth_gt))),
    )

    solve = pba.make_solver(MODEL, images_flat, H, W)
    cfg = ba.BAConfig(max_iterations=30, huber_delta=9.0,
                      function_tolerance=1e-12)
    res_fn = pba.make_residual_fn(MODEL, images_flat, H, W)
    residual_cost, _ = ba.make_ba_step(res_fn, pba.cam_retract, 8)
    cost_gt = float(residual_cost(problem, cfg))  # model-error floor
    cost0 = float(residual_cost(noisy, cfg))
    assert cost0 > 2.0 * cost_gt  # the perturbation must actually hurt
    solved, res = solve(noisy, cfg)
    # converge to (or below) the ground-truth model-error floor — the
    # constant-depth-per-patch approximation leaves a systematic residual,
    # so "as good a fit as ground truth" is the right acceptance
    assert float(res.cost) <= 1.05 * cost_gt, (cost_gt, float(res.cost))

    pose_err = jax.vmap(
        lambda a, b: jnp.linalg.norm(se3.log(se3.compose(se3.inverse(a), b)))
    )(poses_gt, solved.cam_states.pose)
    # poses stay in the GT basin (bias bounded by the model error)
    assert float(jnp.max(pose_err)) < 0.03, np.asarray(pose_err)
    depth_rel = np.abs(
        np.asarray(solved.inv_depth) / np.asarray(inv_depth_gt) - 1
    )
    assert np.median(depth_rel) < 0.01
    # affine brightness recovered to a small fraction of its range
    aff_err = np.abs(
        np.asarray(solved.cam_states.affine) - np.asarray(affine_gt := scene[1])
    )
    assert np.max(aff_err[:, 0]) < 0.02   # a (log-gain)
    assert np.max(aff_err[:, 1]) < 1.0    # b (intensity offset)


@pytest.mark.slow
def test_pba_manual_jacobian_matches_autodiff(scene):
    problem, images_flat, _ = build_pba_problem(scene, L=20)
    o = problem.obs
    cam_a = jax.tree_util.tree_map(lambda x: x[o.anchor_cam], problem.cam_states)
    cam_c = jax.tree_util.tree_map(lambda x: x[o.target_cam], problem.cam_states)
    rho = problem.inv_depth[o.landmark]

    rj = pba.make_rj_fn(MODEL, images_flat, H, W)
    r_man, J_man = jax.vmap(rj)(cam_a, cam_c, rho, o.aux)

    res_fn = pba.make_residual_fn(MODEL, images_flat, H, W)

    def auto_rj(ca, cc, rh, aux):
        def f(d):
            return res_fn(
                pba.cam_retract(ca, d[:8]),
                pba.cam_retract(cc, d[8:16]),
                rh + d[16], aux,
            )
        z = jnp.zeros(17)
        return f(z), jax.jacfwd(f)(z)

    r_auto, J_auto = jax.vmap(auto_rj)(cam_a, cam_c, rho, o.aux)
    np.testing.assert_allclose(np.asarray(r_man), np.asarray(r_auto), atol=1e-9)
    np.testing.assert_allclose(np.asarray(J_man), np.asarray(J_auto),
                               rtol=1e-5, atol=1e-7)


def test_pyramid_utilities():
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.normal(size=(2, 64, 96)))
    pyr = pba.build_pyramid(imgs, 3)
    assert [p[1:] for p in pyr] == [(64, 96), (32, 48), (16, 24)]
    # average-pool correctness
    np.testing.assert_allclose(
        float(pyr[1][0][0, 0, 0]),
        float(imgs[0, :2, :2].mean()), rtol=1e-6,
    )
    # intrinsics scaling: a point projected at full res maps to the scaled
    # pixel location at the coarse level
    intr = jnp.array([100.0, 100.0, 47.5, 31.5, 0, 0, 0, 0])
    p = jnp.array([0.3, -0.2, 2.0])
    uv0 = cameras.project(MODEL, intr, p)
    uv1 = cameras.project(MODEL, pba.scale_intrinsics(intr, 1), p)
    np.testing.assert_allclose(
        np.asarray(uv1), (np.asarray(uv0) + 0.5) / 2 - 0.5, atol=1e-9
    )


@pytest.mark.slow
def test_tile_sampler_matches_gather_sampler():
    """The tile-gather + tap-contraction sampler equals the per-tap gather
    path (same 4-tap bilinear math, different association order)."""
    import numpy as np

    from photometric_bundle_adjustment_tpu.models import synthetic

    problem, images_flat, H, W, _, _ = synthetic.synth_pba_problem(
        K=5, L=96, H=64, W=96, pose_noise=0.01, depth_noise=0.05
    )
    o = problem.obs
    cam_a = jax.tree_util.tree_map(
        lambda x: x[o.anchor_cam], problem.cam_states
    )
    cam_c = jax.tree_util.tree_map(
        lambda x: x[o.target_cam], problem.cam_states
    )
    rho = problem.inv_depth[o.landmark]
    outs = {}
    for sampler in ("tile", "gather"):
        rj = pba.make_rj_fn("pinhole", images_flat, H, W, sampler=sampler)
        res = pba.make_residual_fn(
            "pinhole", images_flat, H, W, sampler=sampler
        )
        r1, J1 = jax.vmap(rj)(cam_a, cam_c, rho, o.aux)
        r2 = jax.vmap(res)(cam_a, cam_c, rho, o.aux)
        outs[sampler] = (r1, J1, r2)
    for a, b in zip(outs["tile"], outs["gather"]):
        # f32 association order differs; values are grey-levels (~1e2)
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-3
        )


def _plain_and_fused_steps(model, problem, images_flat, H, W, host):
    """One build + damped solve (lambda 1e-4) through the plain
    ``make_solver`` formulation (per-block normal equations, ba.schur_solve)
    and through the gather-sampled ``make_fused_solver``."""
    from photometric_bundle_adjustment_tpu.optim import fused

    cfg = ba.BAConfig(huber_delta=9.0)
    lam = jnp.asarray(1e-4, problem.inv_depth.dtype)
    free = ~problem.fixed_cams
    _, build_neq = ba.make_ba_step(
        pba.make_residual_fn(model, images_flat, H, W), pba.cam_retract, 8,
        rj_fn=pba.make_rj_fn(model, images_flat, H, W),
    )
    cost0, *neq0 = jax.jit(build_neq, static_argnums=1)(problem, cfg)
    dc0, dp0 = ba.schur_solve(*neq0, lam, free, problem.lm_valid, cfg)
    solver = pba.make_fused_solver(model, images_flat, H, W)
    plan = fused.plan_for_problem(problem, host=host)
    cost1, neq1 = solver.build(problem, plan, cfg)
    dc1, dp1 = solver.solve_lam(neq1, plan, lam, free, cfg)
    return (cost0, dc0, dp0), (cost1, dc1, dp1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("model", ["pinhole", "ds"])
def test_fused_gather_build_matches_plain_build(model):
    """The gather-sampled fused build with the accelerator plan (what the
    GPU runs in pipeline/pba_refine.py) takes the same LM step as the
    plain make_solver formulation."""
    from photometric_bundle_adjustment_tpu.models import synthetic

    problem, images_flat, H, W, _, _ = synthetic.synth_pba_problem(
        model=model, dtype=jnp.float64
    )
    (c0, dc0, dp0), (c1, dc1, dp1) = _plain_and_fused_steps(
        model, problem, images_flat, H, W, host=False
    )
    assert float(c0) > 0.0
    assert abs(float(c1) - float(c0)) <= 1e-9 * float(c0)
    assert _rel(dc1, dc0) < 1e-8
    assert _rel(dp1, dp0) < 1e-8


@pytest.mark.gpu
def test_fused_gather_build_matches_plain_build_f32_on_gpu():
    """The same step parity in float32 on the card, with f32 matrix
    products pinned to full precision (utils/runtime.configure_runtime)."""
    from photometric_bundle_adjustment_tpu.models import synthetic

    problem, images_flat, H, W, _, _ = synthetic.synth_pba_problem(
        model="ds", dtype=jnp.float32
    )
    with jax.default_matmul_precision("float32"):
        (c0, dc0, dp0), (c1, dc1, dp1) = _plain_and_fused_steps(
            "ds", problem, images_flat, H, W, host=False
        )
    assert _rel(dc1, dc0) < 1e-4
    assert _rel(dp1, dp0) < 1e-4
