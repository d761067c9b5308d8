"""Vectorised RANSAC: relative pose (essential) and absolute pose (PnP).

Batched re-design of the reference's OpenGV usage: instead of the
sequential hypothesise-and-verify loop inside
``sac::Ransac`` (matching_utils.h:81-176 NISTER 5pt;
map_utils.h:242-302 EPnP), we draw a *fixed batch* of minimal samples, turn
each into a model with a vmapped linear solver (8-point essential / DLT
PnP — SVDs batched over the hypothesis axis), score every hypothesis
against every correspondence in one (hypotheses x matches) computation, and
argmax the inlier count.  Static shapes throughout (padded matches +
masks), so the whole thing jits and can itself be vmapped over image pairs.

Nonlinear refinement on the inlier set (OpenGV ``optimize_nonlinear``
equivalents) minimises smooth tangent-space bearing residuals
``f_obs x f_pred`` with the shared LM core, then re-selects inliers with
the refined model (matching_utils.h:139-175 semantics).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from photometric_bundle_adjustment_tpu.core import se3
from photometric_bundle_adjustment_tpu.features import geometry, nister
from photometric_bundle_adjustment_tpu.optim import LMConfig, lm_solve


def _sample_indices(key, num_hyp, sample_size, valid):
    """(num_hyp, sample_size) random indices into rows where ``valid``.

    Indices are distinct *within* each minimal sample (duplicate draws
    produce rank-deficient hypotheses that silently waste budget): each
    hypothesis assigns an i.i.d. uniform score to every valid row and
    takes the top-``sample_size`` — a batched Fisher-Yates equivalent
    that stays one fused (H, M) op on device.
    """
    u = jax.random.uniform(key, (num_hyp, valid.shape[0]))
    u = jnp.where(valid[None, :], u, -1.0)  # invalid rows lose top_k
    _, idx = jax.lax.top_k(u, sample_size)
    return idx.astype(jnp.int32)


# ---------------------------------------------------------------------------
# relative pose
# ---------------------------------------------------------------------------


def _pose_from_Rt(R, t, dtype):
    return se3.make(t.astype(dtype), se3.quat_from_matrix(R.astype(dtype)))


@functools.partial(
    jax.jit, static_argnames=("num_hypotheses", "refine_iters", "solver")
)
def ransac_relative_pose(
    bearings0: jax.Array,     # (M, 3) unit bearings, image 0
    bearings1: jax.Array,     # (M, 3)
    valid: jax.Array,         # (M,) bool
    key: jax.Array,
    threshold: float = 5e-5,  # sfm.cpp:203-204
    min_inliers: int = 16,    # sfm.cpp:205-206
    num_hypotheses: int = 128,
    refine_iters: int = 10,
    solver: str = "nister",
):
    """Returns (T_0_1 (7,), inlier_mask (M,), num_inliers).

    ``inlier_mask`` is all-False when the count is not > min_inliers
    (findInliersRansac leaves inliers empty, matching_utils.h:132).
    Translation is normalised to unit length (matching_utils.h:128-131).

    ``solver``: "nister" (default — the reference's 5-point minimal solver,
    matching_utils.h:111-124, batched re-design in features/nister.py) or
    "eight_point" (needs 8 clean correspondences per sample; kept as the
    cheaper fallback).  The Nister path draws 5-point samples, solves all
    of them simultaneously (up to 10 essential candidates each), prescreens
    every candidate by algebraic epipolar inlier count — one einsum
    over (candidates x matches), threshold 1e-3 as in the reference's
    stereo epipolar test (matching_utils.h:62-79) — and decomposes only
    the top 8 candidates into poses for the full angular scoring.
    """
    M = bearings0.shape[0]
    dtype = bearings0.dtype

    if solver == "nister":
        idx = _sample_indices(key, num_hypotheses, 5, valid)  # (H, 5)
        Es, evalid = jax.vmap(nister.five_point_candidates)(
            bearings0[idx], bearings1[idx]
        )                                            # (H, 10, 3, 3), (H, 10)
        EsF = Es.reshape(-1, 3, 3)
        alg = jnp.abs(
            jnp.einsum("mi,hij,mj->hm", bearings0, EsF, bearings1)
        )
        cnt = jnp.sum((alg <= 1e-3) & valid[None, :], axis=-1)
        cnt = jnp.where(evalid.reshape(-1), cnt, -1)
        _, top = jax.lax.top_k(cnt, 8)
        Rs, ts = jax.vmap(geometry.decompose_essential)(EsF[top])
        poses = jax.vmap(
            jax.vmap(lambda R, t: _pose_from_Rt(R, t, dtype))
        )(Rs, ts).reshape(8 * 4, 7)
    elif solver == "eight_point":
        idx = _sample_indices(key, num_hypotheses, 8, valid)  # (H, 8)
        Es = jax.vmap(geometry.eight_point)(
            bearings0[idx], bearings1[idx]
        )                                                     # (H, 3, 3)
        Rs, ts = jax.vmap(geometry.decompose_essential)(Es)
        poses = jax.vmap(
            jax.vmap(lambda R, t: _pose_from_Rt(R, t, dtype))
        )(Rs, ts).reshape(num_hypotheses * 4, 7)
    else:
        raise ValueError(f"unknown solver {solver!r}")

    def score(pose):
        err = geometry.reprojection_angle_error(bearings0, bearings1, pose)
        inl = (err <= threshold) & valid
        return jnp.sum(inl.astype(jnp.int32))

    scores = jax.vmap(score)(poses)
    best = jnp.argmax(scores)
    T_best = poses[best]

    err = geometry.reprojection_angle_error(bearings0, bearings1, T_best)
    inlier0 = (err <= threshold) & valid

    # --- nonlinear refinement on inliers (optimize_nonlinear equivalent) ---
    w = inlier0.astype(dtype)

    def residual(T):
        p0 = geometry.triangulate_midpoint(bearings0, bearings1, T)
        p1 = se3.act(se3.inverse(T), p0)
        n0 = p0 / jnp.maximum(jnp.linalg.norm(p0, axis=-1, keepdims=True), 1e-12)
        n1 = p1 / jnp.maximum(jnp.linalg.norm(p1, axis=-1, keepdims=True), 1e-12)
        r0 = jnp.cross(bearings0, n0) * w[:, None]
        r1 = jnp.cross(bearings1, n1) * w[:, None]
        return jnp.concatenate([r0, r1]).reshape(-1)

    cfg = LMConfig(max_iterations=refine_iters, function_tolerance=1e-14)
    T_ref, _ = lm_solve(residual, T_best, se3.right_plus, 6, cfg)

    # re-normalise translation (scale is not observable)
    t = se3.translation(T_ref)
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    T_ref = se3.make(t, se3.rotation(T_ref))

    err2 = geometry.reprojection_angle_error(bearings0, bearings1, T_ref)
    inliers = (err2 <= threshold) & valid
    n_inl = jnp.sum(inliers.astype(jnp.int32))
    ok = n_inl > min_inliers
    return T_ref, inliers & ok, jnp.where(ok, n_inl, 0)


# ---------------------------------------------------------------------------
# absolute pose (PnP)
# ---------------------------------------------------------------------------


def _dlt_pnp(f: jax.Array, p: jax.Array):
    """DLT absolute pose from n >= 6 bearing<->point pairs.

    Solves [f]_x (R p + t) = 0 for the 12 entries of [R|t] (T_c_w up to
    scale), then projects R onto SO(3) and fixes scale/sign by cheirality.
    Returns T_c_w (7,).

    The 3D points are Hartley-normalised (centroid-shifted, isotropically
    scaled) before building the system — without this the DLT is badly
    conditioned for the clustered point sets real SfM produces, especially
    in float32.
    """
    n = f.shape[0]
    # normalise points: T_c_w' solves the shifted/scaled problem
    centroid = jnp.mean(p, axis=0)
    scale = jnp.sqrt(jnp.mean(jnp.sum((p - centroid) ** 2, axis=-1))) + 1e-12
    pn = (p - centroid) / scale

    # rows: skew(f) @ [p^T kron I, I] — build (3n, 12), rank 2 each
    S = geometry.skew(f)  # (n, 3, 3)
    # unknown x = [r11 r12 r13 t1 r21.. t2 r31.. t3] grouping rows of [R|t]
    ph = jnp.concatenate([pn, jnp.ones((n, 1), p.dtype)], axis=-1)  # (n, 4)
    A = jnp.einsum("nij,nk->nijk", S, ph).reshape(n * 3, 12)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    x = Vt[-1]
    Rt = x.reshape(3, 4)
    # the nullspace is defined up to +-: pick the sign putting points in
    # front of the camera (cheirality) before projecting onto SO(3)
    pc_raw = p @ Rt[:, :3].T + Rt[:, 3]
    front = jnp.sum(jnp.sign(jnp.sum(f * pc_raw, axis=-1)))
    Rt = Rt * jnp.where(front < 0, -1.0, 1.0)
    R_raw, t_raw = Rt[:, :3], Rt[:, 3]
    U, s, Vt2 = jnp.linalg.svd(R_raw)
    d = jnp.linalg.det(U @ Vt2)
    R = U @ jnp.diag(jnp.array([1.0, 1.0, 1.0], x.dtype).at[2].set(d)) @ Vt2
    # rescale t consistently with normalising R's singular values to 1
    t = t_raw * 3.0 / jnp.maximum(jnp.sum(s), 1e-12)
    # undo the point normalisation: the solved (R, t) satisfies
    # f ~ R (p - c)/s + t, and directions are scale-free, so in the
    # original frame f ~ R p + (s t - R c)
    t = t * scale - R @ centroid
    return _pose_from_Rt(R, t, f.dtype)


def pnp_angle_error(T_c_w: jax.Array, f: jax.Array, p_w: jax.Array) -> jax.Array:
    """1 - cos(angle between observed bearing and predicted direction)
    (the OpenGV absolute-pose SAC error; threshold formula map_utils.h:276)."""
    pc = se3.act(T_c_w, p_w)
    n = pc / jnp.maximum(jnp.linalg.norm(pc, axis=-1, keepdims=True), 1e-12)
    return 1.0 - jnp.sum(f * n, axis=-1)


@functools.partial(
    jax.jit,
    static_argnames=("num_hypotheses", "refine_iters", "lo_rounds", "solver"),
)
def ransac_pnp(
    bearings: jax.Array,   # (M, 3) unit bearings in the camera frame
    points_w: jax.Array,   # (M, 3) world points
    valid: jax.Array,      # (M,) bool
    key: jax.Array,
    pixel_threshold: float = 3.0,  # sfm.cpp:234-235
    num_hypotheses: int = 512,
    refine_iters: int = 10,
    lo_rounds: int = 2,
    solver: str = "p3p",
):
    """Localise a camera: returns (T_w_c (7,), inlier_mask (M,)).

    Threshold is the reference's 1 - cos(atan(px / 500)) conversion
    (map_utils.h:276-277); refinement runs on the RANSAC inliers and the
    inlier set is recomputed with the refined pose (map_utils.h:282-301),
    locally-optimised for ``lo_rounds`` rounds.

    ``solver``: "p3p" (default — Grunert minimal 3-point, features/p3p.py;
    the reference's OpenGV absolute-pose RANSAC analog with the sample
    size a MINIMAL solver allows: P(clean) ~ (1-e)^3) or "dlt" (6-point
    Hartley-normalised DLT; non-minimal, kept as fallback and used by the
    LO refinement on inlier sets).  Measured A/B at 256 hypotheses on
    synthetic scenes (tests/test_features.py): equal success below 40%
    outliers; at 60-70% outliers P3P localises where the DLT's clean-
    sample probability has collapsed.
    """
    dtype = bearings.dtype
    threshold = 1.0 - jnp.cos(jnp.arctan(pixel_threshold / 500.0))

    if solver == "p3p":
        from photometric_bundle_adjustment_tpu.features import p3p as p3p_mod

        idx = _sample_indices(key, num_hypotheses, 3, valid)
        Rs, ts, pvalid = jax.vmap(p3p_mod.p3p_candidates)(
            bearings[idx], points_w[idx]
        )                                  # (H, 4, 3, 3), (H, 4, 3), (H, 4)
        T_cands = jax.vmap(
            jax.vmap(lambda R, t: _pose_from_Rt(R, t, dtype))
        )(Rs, ts).reshape(-1, 7)
        cand_valid = pvalid.reshape(-1)
    elif solver == "dlt":
        idx = _sample_indices(key, num_hypotheses, 6, valid)
        T_cands = jax.vmap(_dlt_pnp)(bearings[idx], points_w[idx])  # (H, 7)
        cand_valid = jnp.ones(T_cands.shape[0], bool)
    else:
        raise ValueError(f"unknown solver {solver!r}")

    def score(T):
        err = pnp_angle_error(T, bearings, points_w)
        return jnp.sum(((err <= threshold) & valid).astype(jnp.int32))

    scores = jnp.where(cand_valid, jax.vmap(score)(T_cands), -1)
    best = jnp.argmax(scores)
    T_ref = T_cands[best]

    cfg = LMConfig(max_iterations=refine_iters, function_tolerance=1e-14)
    for _ in range(lo_rounds):
        inl = (pnp_angle_error(T_ref, bearings, points_w) <= threshold) & valid
        w = inl.astype(dtype)

        def residual(T, w=w):
            pc = se3.act(T, points_w)
            n = pc / jnp.maximum(
                jnp.linalg.norm(pc, axis=-1, keepdims=True), 1e-12
            )
            return (jnp.cross(bearings, n) * w[:, None]).reshape(-1)

        T_try, _ = lm_solve(residual, T_ref, se3.right_plus, 6, cfg)
        # keep the refinement only if it does not lose inliers
        n_new = jnp.sum(
            ((pnp_angle_error(T_try, bearings, points_w) <= threshold) & valid)
            .astype(jnp.int32)
        )
        n_old = jnp.sum(inl.astype(jnp.int32))
        T_ref = jax.tree_util.tree_map(
            lambda a, b: jnp.where(n_new >= n_old, a, b), T_try, T_ref
        )

    inliers = (pnp_angle_error(T_ref, bearings, points_w) <= threshold) & valid
    return se3.inverse(T_ref), inliers
