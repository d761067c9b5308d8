"""Plane-layout geometric-BA build: warp + projection Jacobians + Huber +
per-observation Schur payloads, all as (rows, O) slabs.

The per-observation rj path (models/geometric_ba.make_rj_fn) vmaps tiny
(3, 13)/(2, 13) chain matrices whose 13-wide trailing dims fragment into
padded tiles.  This module re-derives the SAME residual/Jacobian
(golden-tested against optim/fused's build) in plane layout
(core/camera_slab): every quantity lives as a plane slab with the
observation axis contiguous, one 2-D transpose bridges to row-major for the
chunk-plan assembly, and the per-observation Schur payloads A0 = J^T J_rho
/ A1 = J^T r are formed in plane layout so the assembly needs no J-column
passes.

No Pallas is needed: the geometric residual is the 2-pixel reprojection
error (reference: BundleAdjustmentReprojectionCostFunctor,
include/visnav/reprojection.h:74-118) — there is no image sampling, so
XLA fuses the slab math into a handful of wide elementwise kernels.

Output packing (one (O+1, 55) row-major array; columns):
  [0:13)   J_x * sw   (residual x-row, W order [t_a(3) phi_a(3) t_c(3)
           phi_c(3) rho])
  [13:26)  J_y * sw
  26, 27   r_x * sw, r_y * sw
  28       per-observation robust cost (0.5 rho(|r|^2))
  [29:42)  A0 = J^T J_rho-col in W order
  [42:55)  A1 = J^T r in W order
The trailing zero row is the chunk plans' dummy gather target.

Solve path: the normal-equation tuple matches optim/fused.py build_chunk,
so ``camera_slab.solve_lam`` (dense Cholesky on the reduced camera system +
back-substitution) applies unchanged with C = 6.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from photometric_bundle_adjustment_tpu.core import camera_slab, se3
from photometric_bundle_adjustment_tpu.core import cameras
from photometric_bundle_adjustment_tpu.optim import ba
from photometric_bundle_adjustment_tpu.optim.schur_plan import (
    SchurPlan,
    build_schur_plan,
)

C = 6   # camera tangent dim (se3 only; no affine brightness)
W = 13  # [se3_a(6), se3_c(6), rho]


def build_geo_consts(model: str, problem: ba.BAProblem, dtype=jnp.float32):
    """Static plane slabs: anchor unit rays, target intrinsics, measured
    target pixels (host-side, once per solve; no reordering — assembly
    plans are built over the original observation order)."""
    o = problem.obs
    aux = o.aux
    intr_ref = np.asarray(aux.intr_ref)
    uv_ref = np.asarray(aux.uv_ref)
    d = np.asarray(
        cameras.unproject_unit(
            model, jnp.asarray(intr_ref, dtype), jnp.asarray(uv_ref, dtype)
        )
    )                                                   # (O, 3)
    return dict(
        d3=jnp.asarray(d.T, dtype),                     # (3, O)
        intr_t=jnp.asarray(np.asarray(aux.intr_target).T, dtype),  # (8, O)
        uvt=jnp.asarray(np.asarray(aux.uv_target).T, dtype),       # (2, O)
        an=jnp.asarray(np.asarray(o.anchor_cam), jnp.int32),
        tn=jnp.asarray(np.asarray(o.target_cam), jnp.int32),
        lm=jnp.asarray(np.asarray(o.landmark), jnp.int32),
        valid=jnp.asarray(np.asarray(o.valid) != 0),
    )


def build_geo_plan(problem: ba.BAProblem, **kwargs) -> SchurPlan:
    """Chunk-plan assembly tables over the original observation order."""
    o = problem.obs
    K = jax.tree_util.tree_leaves(problem.cam_states)[0].shape[0]
    L = problem.inv_depth.shape[0]
    return build_schur_plan(
        np.asarray(o.anchor_cam), np.asarray(o.target_cam),
        np.asarray(o.landmark), K, L,
        valid=np.asarray(o.valid) != 0, **kwargs,
    )


def _warp_geo(model: str, cam_states, inv_depth, consts, slots=None):
    """Plane-layout warp + projection + Jacobian coefficient slabs.

    Ray-form warp chain for a single center pixel; returns (ux, uy, GA, GB) with GA/GB the (13, O) slabs
    dpi_{u,v}/dtheta.  Projections are NOT finite-masked: parity with the
    vmapped rj path (optim/fused._scaled_jacobians) requires the raw
    values to flow into the residual.

    ``slots``: when the observation rows are slot-major landmark-dense
    (row s*L + l belongs to landmark l), pass S — the landmark-state
    lookup becomes a broadcast instead of a 1-D gather)."""
    poses = cam_states                                  # (K, 7) for the
    #                                                     geometric problem
    pa = poses[consts["an"]]                            # (O, 7)
    pc = poses[consts["tn"]]
    if slots is not None:
        L = inv_depth.shape[0]
        rho = jnp.broadcast_to(
            inv_depth[None, :], (slots, L)
        ).reshape(1, slots * L)                         # (1, O)
    else:
        rho = inv_depth[consts["lm"]][None, :]         # (1, O)
    Ra = camera_slab.rot_planes(pa[:, 3:7])
    Rc = camera_slab.rot_planes(pc[:, 3:7])
    M = [[sum(Rc[i][j] * Ra[i][c_] for i in range(3))[None, :]
          for c_ in range(3)] for j in range(3)]
    dt = [pa[:, i] - pc[:, i] for i in range(3)]
    u = [sum(Rc[i][j] * dt[i] for i in range(3))[None, :] for j in range(3)]

    d = [consts["d3"][j:j + 1] for j in range(3)]       # 3 x (1, O)
    q = [M[j][0] * d[0] + M[j][1] * d[1] + M[j][2] * d[2] + rho * u[j]
         for j in range(3)]

    ux, uy, Jpi0, Jpi1 = camera_slab.project_slab(
        model, consts["intr_t"], q[0], q[1], q[2]
    )

    def coeff(Jp):
        a = [Jp[0] * M[0][c_] + Jp[1] * M[1][c_] + Jp[2] * M[2][c_]
             for c_ in range(3)]
        blocks = [rho * a[0], rho * a[1], rho * a[2]]
        blocks += [d[1] * a[2] - d[2] * a[1],
                   d[2] * a[0] - d[0] * a[2],
                   d[0] * a[1] - d[1] * a[0]]
        blocks += [-rho * Jp[0], -rho * Jp[1], -rho * Jp[2]]
        blocks += [Jp[1] * q[2] - Jp[2] * q[1],
                   Jp[2] * q[0] - Jp[0] * q[2],
                   Jp[0] * q[1] - Jp[1] * q[0]]
        blocks += [Jp[0] * u[0] + Jp[1] * u[1] + Jp[2] * u[2]]
        return jnp.concatenate(blocks, axis=0)          # (13, O)

    return ux, uy, coeff(Jpi0), coeff(Jpi1)


def _geo_payload(model: str, problem: ba.BAProblem, consts,
                 cfg: ba.BAConfig, slots=None):
    """Plane-layout residual/Jacobian/payload evaluation; returns
    ``(cost, plane)`` with plane the (55, O) slab of the module
    docstring's packing (pre-transpose)."""
    ux, uy, GA, GB = _warp_geo(
        model, problem.cam_states, problem.inv_depth, consts, slots=slots
    )

    vb = consts["valid"][None, :]                       # (1, O) bool
    # where, not multiply: padding observations can project to inf/NaN
    # (zero rays, z = 0) and NaN * 0 = NaN
    rx = jnp.where(vb, consts["uvt"][0:1] - ux, 0.0)
    ry = jnp.where(vb, consts["uvt"][1:2] - uy, 0.0)
    r2 = rx * rx + ry * ry                              # (1, O)
    delta = float(cfg.huber_delta)
    if delta > 0:
        sq = jnp.sqrt(jnp.maximum(r2, 1e-300))
        inl = r2 <= delta * delta
        wgt = jnp.where(inl, jnp.ones_like(r2), delta / sq)
        cost_row = 0.5 * jnp.where(
            inl, r2, 2.0 * delta * sq - delta * delta
        )
    else:
        wgt = jnp.ones_like(r2)
        cost_row = 0.5 * r2
    vrow = vb.astype(rx.dtype)
    wgt = wgt * vrow
    cost_row = cost_row * vrow
    sw = jnp.sqrt(wgt)                                  # (1, O)

    Jx = jnp.where(vb, -GA * sw, 0.0)                   # (13, O)
    Jy = jnp.where(vb, -GB * sw, 0.0)
    rswx = rx * sw
    rswy = ry * sw
    A0 = Jx * Jx[12:13] + Jy * Jy[12:13]                # (13, O)
    A1 = Jx * rswx + Jy * rswy

    plane = jnp.concatenate(
        [Jx, Jy, rswx, rswy, cost_row, A0, A1], axis=0
    )                                                   # (55, O)
    return jnp.sum(plane[28]), plane


def _schur_corr(M, g_p, inv0, cfg: ba.BAConfig):
    Mw = M * inv0[:, None]
    if cfg.skip_schur_gram:
        S_corr0 = None
    else:
        prec = (jax.lax.Precision.HIGH
                if cfg.schur_matmul_precision == "high"
                else jax.lax.Precision.HIGHEST)
        S_corr0 = jax.lax.dot(Mw.T, M, precision=prec)
    return S_corr0, Mw.T @ g_p


def build_geo(model: str, problem: ba.BAProblem, consts, cplan: SchurPlan,
              cfg: ba.BAConfig):
    """One normal-equation assembly (chunk plans, ragged observation
    order); returns the optim/fused build_chunk ``(cost, neq)`` contract
    (C = 6)."""
    from photometric_bundle_adjustment_tpu.optim.fused import _chunk_sum

    K = jax.tree_util.tree_leaves(problem.cam_states)[0].shape[0]
    L = problem.inv_depth.shape[0]
    cost, plane = _geo_payload(model, problem, consts, cfg)
    dtype = plane.dtype
    outT = jnp.pad(plane.T, ((0, 1), (0, 0)))           # (O+1, 55)

    # H_cc pair-Gram over cameras-only columns (rows alternate x/y)
    rows = outT[:, :26][jnp.asarray(cplan.pg)]          # (NCp, B, 26)
    rows2 = rows.reshape(rows.shape[0], -1, 13)[..., :12]
    G2 = jnp.einsum("nbi,nbj->nij", rows2, rows2)       # (NCp, 12, 12)
    blocks = jnp.stack(
        [G2[:, :C, :C], G2[:, :C, C:], G2[:, C:, :C], G2[:, C:, C:]],
        axis=1,
    ).reshape(-1, C * C)
    H_cc = (
        jnp.zeros((K * K + 1, C * C), dtype)
        .at[jnp.asarray(cplan.cc_rows4).reshape(-1)]
        .add(blocks)[: K * K]
        .reshape(K, K, C, C)
    )

    A0r = outT[:, 29:42]                                # (O+1, 13)
    A1r = outT[:, 42:55]
    pay_l = jnp.concatenate(
        [A0r[:, :C], A0r[:, 12:13], A1r[:, 12:13]], axis=1
    )
    red_l = _chunk_sum(pay_l, cplan.lm, L)
    anchor_v, H_pp, g_p = red_l[:, :C], red_l[:, C], red_l[:, C + 1]

    g_c = (
        _chunk_sum(A1r[:, :C], cplan.gc_a, K)
        + _chunk_sum(A1r[:, C:2 * C], cplan.gc_t, K)
    )

    lm_mask = problem.lm_valid.astype(dtype)
    inv0 = lm_mask / jnp.maximum(H_pp, cfg.min_inv_depth_hessian)
    oh = jax.nn.one_hot(cplan.lm_cam, K, dtype=dtype)
    vt = A0r[:, C:2 * C]
    rows_t = vt[jnp.asarray(cplan.lm.gidx)]
    part = jnp.einsum("nbk,nbc->nkc", oh, rows_t)
    M = (
        jnp.zeros((L + 1, K * C), dtype)
        .at[jnp.asarray(cplan.lm.rows)]
        .add(part.reshape(part.shape[0], K * C))[:L]
    )
    oh_a = jax.nn.one_hot(cplan.anchor_cam_of_lm, K, dtype=dtype)
    M = M + (oh_a[:, :, None] * anchor_v[:, None, :]).reshape(L, K * C)

    S_corr0, rhs_corr0 = _schur_corr(M, g_p, inv0, cfg)
    H_cc_mat = jnp.transpose(H_cc, (0, 2, 1, 3)).reshape(K * C, K * C)
    return cost, (H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0)


def build_geo_dense(model: str, problem: ba.BAProblem, consts, plan,
                    cfg: ba.BAConfig):
    """Slot-major dense assembly (fused.densify_problem layout): every
    landmark reduction is a reshape + sum over the slot axis, g_c is two
    one-hot matmuls — on uniform problems a much cheaper assembly than the
    chunk plans.
    ``plan`` is the DenseLmSchurPlan; ``consts`` must be built from the
    DENSIFIED problem so plane columns are already slot-ordered."""
    K = jax.tree_util.tree_leaves(problem.cam_states)[0].shape[0]
    L = problem.inv_depth.shape[0]
    cost, plane = _geo_payload(model, problem, consts, cfg)
    dtype = plane.dtype
    outT = plane.T                                      # (S*L, 55)
    # the dense plan's dummy pair-gathers point at row S*L (one past the
    # end); pad a zero row for them
    outTp = jnp.pad(outT, ((0, 1), (0, 0)))

    rows = outTp[:, :26][jnp.asarray(plan.pg)]          # (NCp, B, 26)
    rows2 = rows.reshape(rows.shape[0], -1, 13)[..., :12]
    G2 = jnp.einsum("nbi,nbj->nij", rows2, rows2)
    blocks = jnp.stack(
        [G2[:, :C, :C], G2[:, :C, C:], G2[:, C:, :C], G2[:, C:, C:]],
        axis=1,
    ).reshape(-1, C * C)
    H_cc = (
        jnp.zeros((K * K + 1, C * C), dtype)
        .at[jnp.asarray(plan.cc_rows4).reshape(-1)]
        .add(blocks)[: K * K]
        .reshape(K, K, C, C)
    )

    S_ = plan.lm_cam.shape[0]
    A0r = outT[:, 29:42].reshape(S_, L, 13)
    A1r = outT[:, 42:55]
    red0 = A0r.sum(0)                                   # (L, 13)
    anchor_v = red0[:, :C]
    H_pp = red0[:, 12]
    g_p = A1r[:, 12].reshape(S_, L).sum(0)

    # camera-indexed lifts as compare+multiply+reduce (not one-hot
    # matmuls): XLA fuses the one-hot generation into the reduction and
    # never writes the (O, K)/(S, L, K) lift slabs to device memory; exact f32
    # (see optim/fused.py build_dense, same rewrite)
    iot = jnp.arange(K, dtype=jnp.int32)
    man = (jnp.asarray(plan.obs_anchor_cam)[:, None] == iot).astype(dtype)
    mtn = (jnp.asarray(plan.obs_target_cam)[:, None] == iot).astype(dtype)
    g_c = (jnp.sum(man[:, :, None] * A1r[:, None, :C], axis=0)
           + jnp.sum(mtn[:, :, None] * A1r[:, None, C:2 * C], axis=0))

    lm_mask = problem.lm_valid.astype(dtype)
    inv0 = lm_mask / jnp.maximum(H_pp, cfg.min_inv_depth_hessian)
    vt_sl = A0r[:, :, C:2 * C]                          # (S, L, C)
    msk = (jnp.asarray(plan.lm_cam)[:, :, None] == iot).astype(dtype)
    M = jnp.sum(msk[..., None] * vt_sl[:, :, None, :], axis=0)
    amsk = (jnp.asarray(plan.anchor_cam_of_lm)[:, None] == iot
            ).astype(dtype)
    M = (M + amsk[:, :, None] * anchor_v[:, None, :]).reshape(L, K * C)

    S_corr0, rhs_corr0 = _schur_corr(M, g_p, inv0, cfg)
    H_cc_mat = jnp.transpose(H_cc, (0, 2, 1, 3)).reshape(K * C, K * C)
    return cost, (H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0)


def build_geo_dense2(model: str, problem: ba.BAProblem, consts, plan,
                     cfg: ba.BAConfig):
    """Plane-native dense assembly: every reduction consumes the (55, O)
    payload plane DIRECTLY (no (O+1, 55) transpose+pad copy):

      * only the 26 Jacobian rows are transposed (for the camera-pair Gram
        gather, which must gather along observations);
        dummy chunk slots are handled by a static mask instead of a padded
        zero row,
      * landmark reductions are (rows, S, L) reshapes + sums over the slot
        axis in plane layout,
      * the Schur coupling is built TRANSPOSED, ``Ms_p (K*C, L)``, and
        pre-scaled by sqrt(inv0) during the lift — the gram
        S_corr0 = Ms_p @ Ms_p^T needs no separate (L, K*C) weighted copy
        (a ``Mw = M * inv0`` materialisation would cost ~39 MB of device
        memory traffic per iteration),
      * g_c target/anchor contributions ride the same compare-reduce lifts.

    Requires ``consts`` to carry the clamped pair-gather table ``pgc`` and
    its dummy mask ``pgm`` (added by :func:`make_geo_solver`).  Returns the
    v2 neq contract consumed by :func:`solve_lam2`:
    ``(H_cc_mat, S_corr0, rhs_corr0, g_c, g_p, Ms_p, inv0, s)`` with
    ``s = sqrt(inv0)``.  Parity with :func:`build_geo_dense` is golden-
    tested (tests/test_geo_mega.py).  Ref: the Ceres SPARSE_SCHUR
    elimination being replaced, include/visnav/map_utils.h:322-399.
    """
    K = jax.tree_util.tree_leaves(problem.cam_states)[0].shape[0]
    L = problem.inv_depth.shape[0]
    S_ = plan.lm_cam.shape[0]
    cost, plane = _geo_payload(model, problem, consts, cfg, slots=S_)
    dtype = plane.dtype

    # H_cc pair-Gram: transpose only the 26 J rows; dummy slots masked
    rowsJ = plane[:26].T                                # (O, 26)
    rows = rowsJ[consts["pgc"]] * consts["pgm"][:, :, None]
    rows2 = rows.reshape(rows.shape[0], -1, 13)[..., :12]
    G2 = jnp.einsum("nbi,nbj->nij", rows2, rows2)       # (NCp, 12, 12)
    blocks = jnp.stack(
        [G2[:, :C, :C], G2[:, :C, C:], G2[:, C:, :C], G2[:, C:, C:]],
        axis=1,
    ).reshape(-1, C * C)
    # COMPONENT-MAJOR reduced-system ordering (row r = c*K + k): the
    # camera-major (K, C, K, C) block transpose puts C = 6 in the minor
    # dimension; with components major the intermediate is (C, K, C, K),
    # whose minor dimension is K.  The ordering is internal to
    # this build + solve_lam2 (the delta reshapes back to (K, C)).
    H_cc = (
        jnp.zeros((K * K + 1, C * C), dtype)
        .at[jnp.asarray(plan.cc_rows4).reshape(-1)]
        .add(blocks)[: K * K]
        .reshape(K, K, C, C)
    )
    H_cc_mat = jnp.transpose(H_cc, (2, 0, 3, 1)).reshape(K * C, K * C)

    # plane-layout landmark reductions: (rows, S, L) sums over slots
    A0p = plane[29:42].reshape(13, S_, L)
    A1p = plane[42:55].reshape(13, S_, L)
    red0 = A0p.sum(1)                                   # (13, L)
    anchor_v = red0[:C]                                 # (C, L)
    H_pp = red0[12]                                     # (L,)
    a1red = A1p.sum(1)                                  # (13, L)
    g_p = a1red[12]

    lm_mask = problem.lm_valid.astype(dtype)
    inv0 = lm_mask / jnp.maximum(H_pp, cfg.min_inv_depth_hessian)
    s = jnp.sqrt(inv0)                                  # (L,)

    # camera lifts as compare+multiply+reduce (fused one-hot; exact f32 —
    # einsum would lower these as matmuls, see optim/fused.py build_dense).
    # Padding slots carry camera id K, matching no iota row.  The anchor
    # contribution rides as one EXTRA virtual slot (consts["lm_cam_ext"]
    # stacks anchor_cam_of_lm under lm_cam) so the reduce lands directly
    # in the 2-D (C*K, L) layout — a separate 3-D sum + anchor add +
    # reshape would materialize the 39 MB coupling twice.
    iot = jnp.arange(K, dtype=jnp.int32)
    msk = (consts["lm_cam_ext"][None] == iot[:, None, None]
           ).astype(dtype)                              # (K, S+1, L)
    vt_ext = jnp.concatenate(
        [A0p[C:2 * C] * s[None, None, :],
         (anchor_v * s[None, :])[:, None, :]], axis=1,
    )                                                   # (C, S+1, L)
    Ms_p = jnp.sum(
        (vt_ext[:, None] * msk[None]).reshape(C * K, S_ + 1, L), axis=1
    )                                                   # (C*K, L)

    # g_c through the same extended-slot lift on A1 ((C, K), c-major)
    a1_ext = jnp.concatenate(
        [A1p[C:2 * C], a1red[:C][:, None, :]], axis=1
    )                                                   # (C, S+1, L)
    g_c = jnp.sum(a1_ext[:, None] * msk[None], axis=(2, 3))

    if cfg.skip_schur_gram:
        S_corr0 = None
    else:
        prec = (jax.lax.Precision.HIGH
                if cfg.schur_matmul_precision == "high"
                else jax.lax.Precision.HIGHEST)
        S_corr0 = jax.lax.dot_general(
            Ms_p, Ms_p, (((1,), (1,)), ((), ())), precision=prec
        )                                               # (K*C, K*C)
    rhs_corr0 = Ms_p @ (s * g_p)
    return cost, (H_cc_mat, S_corr0, rhs_corr0, g_c, g_p, Ms_p, inv0, s)


def solve_lam2(neq, lam, free_cam_mask, cfg: ba.BAConfig):
    """Per-lambda dense solve + back-substitution for the v2 neq contract
    (COMPONENT-MAJOR reduced system, row c*K + k; scaled transposed
    coupling — no unscaled M needed: (M @ dc) * inv0 == s * (dc @ Ms_p)
    with s = sqrt(inv0))."""
    H_cc_mat, S_corr0, rhs_corr0, g_c, g_p, Ms_p, inv0, s = neq
    KC = H_cc_mat.shape[0]
    K = free_cam_mask.shape[0]
    C_ = KC // K
    dtype = g_c.dtype
    d_cc = jnp.clip(jnp.diagonal(H_cc_mat), 1e-12, 1e32)
    S = H_cc_mat + jnp.diag(lam * d_cc) - S_corr0 / (1.0 + lam)
    rhs = -(g_c.reshape(-1) - rhs_corr0 / (1.0 + lam))
    mask = jnp.tile(free_cam_mask.astype(dtype), C_)
    S = S * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
    cho = jax.scipy.linalg.cho_factor(S, lower=True)
    delta_c = jax.scipy.linalg.cho_solve(cho, rhs * mask) * mask
    delta_p = -(g_p * inv0 + s * (delta_c @ Ms_p)) / (1.0 + lam)
    return delta_c.reshape(C_, K).T, delta_p


def make_geo_solver(model: str, problem: ba.BAProblem,
                    plan_slot=None, *, pow2_buckets: bool = False,
                    v2: bool = True):
    """Plane-layout geometric LM build/solve for a fixed observation graph.

    With ``plan_slot`` (a DenseLmSchurPlan; ``problem`` must be the
    matching densify_problem output): slot-major dense assembly — the
    fastest formulation for near-uniform observation counts; ``v2``
    (default) selects the plane-native assembly
    (:func:`build_geo_dense2`).  Without ``plan_slot``: chunk-plan
    assembly over the original ragged order.

    Returns ``solve(problem, cfg) -> (problem, BAResult)`` with
    ``.build`` / ``.solve_lam`` exposed (camera_slab.solve_lam works for
    any camera tangent width)."""
    import numpy as np

    from photometric_bundle_adjustment_tpu.models import geometric_ba

    solve_lam_impl = camera_slab.solve_lam
    if plan_slot is not None:
        cplan = plan_slot
        build_impl = build_geo_dense
        if v2:
            build_impl = build_geo_dense2
            solve_lam_impl = solve_lam2
    else:
        cplan = build_geo_plan(problem, pow2_buckets=pow2_buckets)
        build_impl = build_geo
    consts = build_geo_consts(model, problem)
    if plan_slot is not None and v2:
        # static pair-gather table with dummies clamped in-range + a mask
        # (replaces the (O+1, 55) runtime pad copy of the v1 build)
        pg = np.asarray(cplan.pg)
        Opad = int(np.asarray(problem.obs.valid).shape[0])
        consts["pgc"] = jnp.asarray(
            np.minimum(pg, Opad - 1).astype(np.int32))
        consts["pgm"] = jnp.asarray((pg < Opad).astype(np.float32))
        # target cams per slot with the anchor cam appended as one extra
        # virtual slot (the extended-slot camera lift, build_geo_dense2)
        consts["lm_cam_ext"] = jnp.asarray(np.concatenate(
            [np.asarray(cplan.lm_cam),
             np.asarray(cplan.anchor_cam_of_lm)[None, :]], axis=0,
        ).astype(np.int32))

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def _build(problem, consts, cplan, cfg):
        with jax.default_matmul_precision("float32"):
            return build_impl(model, problem, consts, cplan, cfg)

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def _solve_lam(neq, lam, free, cfg):
        with jax.default_matmul_precision("float32"):
            return solve_lam_impl(neq, lam, free, cfg)

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def _solve(problem, consts, cplan, cfg):
        with jax.default_matmul_precision("float32"):
            free = ~problem.fixed_cams
            init_cost, neq0 = build_impl(model, problem, consts, cplan,
                                         cfg)
            dtype = problem.inv_depth.dtype

            def apply_step(prob, dc, dp):
                new_cams = jax.vmap(geometric_ba.cam_retract)(
                    prob.cam_states, dc
                )
                return prob._replace(
                    cam_states=new_cams, inv_depth=prob.inv_depth + dp
                )

            def body(state):
                prob, lam, cost, neq, rejects, iters, tries, done = state
                dc, dp = solve_lam_impl(neq, lam, free, cfg)
                p_try = apply_step(prob, dc, dp)
                cost_try, neq_try = build_impl(
                    model, p_try, consts, cplan, cfg
                )
                ok = (cost_try < cost) & jnp.isfinite(cost_try)
                prob_new = prob._replace(
                    cam_states=jax.tree_util.tree_map(
                        lambda a, b: jnp.where(ok, a, b),
                        p_try.cam_states, prob.cam_states,
                    ),
                    inv_depth=jnp.where(
                        ok, p_try.inv_depth, prob.inv_depth
                    ),
                )
                neq_new = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(ok, a, b), neq_try, neq
                )
                cost_new = jnp.where(ok, cost_try, cost)
                lam_new = jnp.where(
                    ok, jnp.maximum(lam / 3.0, cfg.min_lambda), lam * 10.0
                )
                rejects_new = jnp.where(ok, 0, rejects + 1)
                small = ok & (
                    jnp.abs(cost - cost_try)
                    <= cfg.function_tolerance * jnp.maximum(cost, 1e-300)
                )
                done_new = small | (rejects_new >= cfg.max_retries) | (
                    lam_new > cfg.max_lambda
                )
                return (prob_new, lam_new, cost_new, neq_new, rejects_new,
                        iters + ok.astype(jnp.int32), tries + 1, done_new)

            def cond(state):
                _, _, _, _, _, iters, tries, done = state
                return (~done) & (iters < cfg.max_iterations) & (
                    tries < cfg.max_iterations * cfg.max_retries
                )

            state0 = (
                problem, jnp.asarray(cfg.init_lambda, dtype), init_cost,
                neq0, jnp.asarray(0), jnp.asarray(0), jnp.asarray(0),
                jnp.asarray(False),
            )
            prob, lam, cost, _, _, iters, _, _ = jax.lax.while_loop(
                cond, body, state0
            )
            return prob, ba.BAResult(
                cost=cost, initial_cost=init_cost, iterations=iters, lam=lam
            )

    def solve(problem, cfg: ba.BAConfig = ba.BAConfig()):
        return _solve(problem, consts, cplan, cfg)

    solve.build = lambda problem, cfg: _build(problem, consts, cplan, cfg)
    solve.solve_lam = _solve_lam
    solve.consts = consts
    solve.plan = cplan
    return solve
