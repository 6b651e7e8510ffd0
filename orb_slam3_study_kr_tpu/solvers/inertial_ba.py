"""Visual-inertial bundle adjustment: joint optimization of keyframe body
states (pose, velocity, IMU biases) and landmarks.

Replaces Optimizer::LocalInertialBA (/root/reference/src/Optimizer.cc:2387:
temporal window Nd=10, 25 if bLarge; the keyframe before the window fixed;
<=200 fixed visual observers; per-KF bias vertices with gyro/acc
random-walk edges) and Optimizer::FullInertialBA (:393: whole map; in init
mode a single shared bias vertex with priorG/priorA prior edges and no
random-walk edges; Huber sqrt(16.92) on the 9-D preintegration edges,
:543).

Formulation: each keyframe is a 15-dof state [phi, dp, dv, dbg, dba]
in one dense (K*15, K*15) reduced system; landmarks are eliminated with a
batched Schur complement exactly like the visual solver (solvers/
local_ba.py), but the correction only lands on the pose dims [0:6] of each
state.  Visual Jacobians are closed-form; the 9-D preintegration edges get
their 24-dim pair Jacobians from forward-mode autodiff (edges are few).
LM damping with accept/reject runs in a lax.scan.
"""

import functools

import jax
import jax.numpy as jnp

from orb_slam3_study_kr_tpu.imu.preintegration import (GRAVITY, Preintegrated)
from orb_slam3_study_kr_tpu.lie.so3 import exp_so3, hat, log_so3, \
    normalize_rotation
from orb_slam3_study_kr_tpu.solvers import robust

# Huber delta on whitened 9-D inertial edges (Optimizer.cc:543).
CHI2_INERTIAL = 16.92


def _edge_residual(R1, p1, v1, R2, p2, v2, bias, pre: Preintegrated, g):
    """9-D preintegration residual (EdgeInertial, G2oTypes.cc:514-560)."""
    db = bias - pre.bias
    dbg, dba = db[:3], db[3:]
    dR = pre.dR @ exp_so3(pre.JRg @ dbg)
    dV = pre.dV + pre.JVg @ dbg + pre.JVa @ dba
    dP = pre.dP + pre.JPg @ dbg + pre.JPa @ dba
    t = pre.dT
    e_R = log_so3(dR.T @ R1.T @ R2)
    e_v = R1.T @ (v2 - v1 - g * t) - dV
    e_p = R1.T @ (p2 - p1 - v1 * t - 0.5 * g * t * t) - dP
    return jnp.concatenate([e_R, e_v, e_p])


def _edge_whitening(pre_stack, eps=1e-8):
    """(E, 9, 9) whitening W = chol(inv(cov9))^T per edge."""
    C = pre_stack.cov[:, :9, :9]
    C = C + eps * jnp.eye(9)[None]
    L = jnp.linalg.cholesky(jnp.linalg.inv(C))
    return jnp.swapaxes(L, -1, -2)


@functools.partial(
    jax.jit,
    static_argnames=("project_fn", "project_jac_fn", "n_iters", "shared_bias",
                     "wide_fov"),
)
def inertial_bundle_adjust(
    project_fn, project_jac_fn,
    R_wb, p_wb, v_w, bias,        # (K,3,3) (K,3) (K,3) (K,6) body states
    fixed,                        # (K,) 1.0 = frozen pose
    R_cb, t_cb,                   # camera <- body extrinsics (Tbc inverse)
    X, lm_mask,                   # (M,3), (M,)
    obs_pose, obs_lm, obs_uv, obs_level, obs_mask,  # visual COO
    edge_i, edge_j, pre_stack, edge_mask,  # (E,) inertial chain edges
    n_iters: int = 10,
    shared_bias: bool = False,    # FullInertialBA bInit mode
    bias_src=None,                # state index holding the shared bias
    prior_gyro: float = 0.0,      # bias prior information (init stages)
    prior_acc: float = 0.0,
    init_lambda: float = 1e-4,
    obs_ur=None, bf=None,
    fixed_vb=None,                # (K,) 1.0 = frozen vel+bias (default =
                                  # fixed; a gauge anchor can free these)
    wide_fov: bool = False,       # fisheye: |p| > 0 cheirality, not z > 0
):
    """Returns (R_wb, p_wb, v_w, bias, X, chi2_vis (O,), cost).

    edge_i/edge_j index into the K states (temporal chain; masked edges are
    no-ops).  In shared_bias mode every inertial edge reads the bias of
    state `bias_src` and random-walk edges are dropped (FullInertialBA
    bInit semantics); otherwise edge e uses state edge_i[e]'s bias and a
    6-D random-walk edge couples the two states' biases.
    """
    K = R_wb.shape[0]
    M = X.shape[0]
    E = edge_i.shape[0]
    dtype = R_wb.dtype
    g = GRAVITY.astype(dtype)
    if bias_src is None:
        bias_src = K - 1

    fvb = fixed if fixed_vb is None else fixed_vb

    inv_sigma2 = robust.octave_inv_sigma2(obs_level)
    if obs_ur is None:
        chi2_gate = robust.CHI2_MONO
    else:
        chi2_gate = jnp.where(obs_ur >= 0, robust.CHI2_STEREO,
                              robust.CHI2_MONO)
    huber_delta = jnp.sqrt(jnp.asarray(chi2_gate, dtype))

    W9 = _edge_whitening(pre_stack)
    # Bias random-walk whitening from the accumulated walk covariance
    # (EdgeGyroRW/EdgeAccRW information, diagonal by construction).
    w_rw = jnp.concatenate([
        1.0 / jnp.sqrt(jnp.maximum(
            pre_stack.cov[:, 9 + i, 9 + i], 1e-14))[:, None]
        for i in range(6)
    ], axis=1)  # (E, 6)

    # Inertial-edge bias source: shared vertex or the edge's first state.
    ebias_src = (jnp.full((E,), bias_src, jnp.int32) if shared_bias
                 else edge_i.astype(jnp.int32))

    def vis_terms_clean(R_all, p_all, X_all):
        """Residuals + closed-form Jacobians of the visual edges w.r.t.
        body-state increments (right-multiplicative on R_wb):
        with q = R_wb^T (X - p_wb) and p_cam = R_cb q + t_cb,
          dp_cam/dphi = R_cb hat(q),  dp_cam/ddp = -R_cb R_wb^T,
          dp_cam/dX = R_cb R_wb^T."""
        Ro = R_all[obs_pose]
        po = p_all[obs_pose]
        Xo = X_all[obs_lm]
        q = jnp.einsum("nji,nj->ni", Ro, Xo - po)        # R_wb^T (X - p)
        pc = jnp.einsum("ab,nb->na", R_cb, q) + t_cb
        uv_hat = project_fn(pc)
        r = uv_hat - obs_uv
        Jp = project_jac_fn(pc)                          # (O, 2, 3)
        if obs_ur is not None:
            z = jnp.maximum(pc[..., 2], 1e-6)
            ur_hat = uv_hat[..., 0] - bf / z
            has_ur = (obs_ur >= 0).astype(dtype)
            r3 = (ur_hat - obs_ur) * has_ur
            J3 = Jp[..., 0, :] + jnp.stack(
                [jnp.zeros_like(z), jnp.zeros_like(z), bf / (z * z)], -1)
            J3 = J3 * has_ur[..., None]
            r = jnp.concatenate([r, r3[..., None]], -1)
            Jp = jnp.concatenate([Jp, J3[..., None, :]], -2)
        RcRbw = jnp.einsum("ab,ncb->nac", R_cb, Ro)      # R_cb @ R_wb^T
        dq_dphi = hat(q)                                 # (O, 3, 3)
        J_phi = jnp.einsum("nda,ab,nbc->ndc", Jp,
                           R_cb, dq_dphi)                # (O, D, 3)
        J_dp = -jnp.einsum("nda,nab->ndb", Jp, RcRbw)
        J_X = jnp.einsum("nda,nab->ndb", Jp, RcRbw)
        J_pose6 = jnp.concatenate([J_phi, J_dp], axis=-1)  # (O, D, 6)
        # Fisheye (KB8) observations past 90 deg off-axis are legitimate:
        # gate on range, not depth (same as solvers/local_ba.py).
        depth_ok = ((jnp.linalg.norm(pc, axis=-1) > 1e-3) if wide_fov
                    else (pc[..., 2] > 1e-3)).astype(dtype)
        return r, J_pose6, J_X, depth_ok

    def inertial_residual_block(R_all, p_all, v_all, b_all):
        """(E, 9) whitened inertial residuals at the current state."""
        def one(e):
            pre_e = jax.tree_util.tree_map(lambda a: a[e], pre_stack)
            i, j, bs = edge_i[e], edge_j[e], ebias_src[e]
            r = _edge_residual(R_all[i], p_all[i], v_all[i],
                               R_all[j], p_all[j], v_all[j],
                               b_all[bs], pre_e, g)
            return W9[e] @ r
        return jax.vmap(one)(jnp.arange(E))

    def inertial_jacobians(R_all, p_all, v_all, b_all):
        """Per-edge 24-dim Jacobians via forward-mode autodiff.

        Local edge state: [phi_i(3), dp_i(3), dv_i(3), dbias_src(6),
        phi_j(3), dp_j(3), dv_j(3)]."""
        def res_e(dx, e):
            pre_e = jax.tree_util.tree_map(lambda a: a[e], pre_stack)
            i, j, bs = edge_i[e], edge_j[e], ebias_src[e]
            R1 = R_all[i] @ exp_so3(dx[0:3])
            p1 = p_all[i] + dx[3:6]
            v1 = v_all[i] + dx[6:9]
            b = b_all[bs] + dx[9:15]
            R2 = R_all[j] @ exp_so3(dx[15:18])
            p2 = p_all[j] + dx[18:21]
            v2 = v_all[j] + dx[21:24]
            r = _edge_residual(R1, p1, v1, R2, p2, v2, b, pre_e, g)
            return W9[e] @ r

        def one(e):
            z = jnp.zeros(24, dtype)
            r = res_e(z, e)
            J = jax.jacfwd(res_e)(z, e)
            return r, J
        return jax.vmap(one)(jnp.arange(E))

    def edge_cols(e):
        """Global column indices (24,) of edge e's local state."""
        i, j, bs = edge_i[e], edge_j[e], ebias_src[e]
        return jnp.concatenate([
            i * 15 + jnp.arange(0, 9),
            bs * 15 + jnp.arange(9, 15),
            j * 15 + jnp.arange(0, 9),
        ])

    all_edge_cols = jax.vmap(edge_cols)(jnp.arange(E))   # (E, 24)

    rw_cols = jnp.concatenate([
        edge_i[:, None] * 15 + jnp.arange(9, 15)[None],
        edge_j[:, None] * 15 + jnp.arange(9, 15)[None],
    ], axis=1)                                           # (E, 12)

    free = (1.0 - fixed).astype(dtype)
    n_dim = K * 15
    pose_dims = (jnp.arange(K)[:, None] * 15 + jnp.arange(6)[None]).reshape(-1)

    def full_cost(R_all, p_all, v_all, b_all, X_all):
        r_v, _, _, depth_ok = vis_terms_clean(R_all, p_all, X_all)
        chi2 = jnp.sum(r_v * r_v, -1) * inv_sigma2
        valid = obs_mask * lm_mask[obs_lm] * depth_ok
        c_vis = jnp.sum(_huber_rho_vis(chi2) * valid)
        r_i = inertial_residual_block(R_all, p_all, v_all, b_all)
        chi2_i = jnp.sum(r_i * r_i, -1)
        c_in = jnp.sum(_huber_rho_in(chi2_i) * edge_mask)
        if not shared_bias:
            r_rw = (b_all[edge_j] - b_all[edge_i]) * w_rw
            c_in = c_in + jnp.sum(jnp.sum(r_rw * r_rw, -1) * edge_mask)
        bsb = b_all[bias_src]
        c_pr = prior_gyro * jnp.sum(bsb[:3] ** 2) + \
            prior_acc * jnp.sum(bsb[3:] ** 2)
        return c_vis + c_in + c_pr

    def _huber_rho_vis(chi2):
        d2 = chi2_gate
        d = huber_delta
        rr = jnp.sqrt(jnp.maximum(chi2, 1e-12))
        return jnp.where(chi2 <= d2, chi2, 2 * d * rr - d2)

    def _huber_rho_in(chi2):
        d2 = CHI2_INERTIAL
        d = jnp.sqrt(jnp.asarray(d2, dtype))
        rr = jnp.sqrt(jnp.maximum(chi2, 1e-12))
        return jnp.where(chi2 <= d2, chi2, 2 * d * rr - d2)

    def lm_step(carry, _):
        R_all, p_all, v_all, b_all, X_all, lam, cost_prev = carry

        # ---------------- visual part + landmark Schur ------------------
        r_v, J_pose6, J_X, depth_ok = vis_terms_clean(R_all, p_all, X_all)
        chi2 = jnp.sum(r_v * r_v, -1) * inv_sigma2
        valid = obs_mask * lm_mask[obs_lm] * depth_ok
        w = inv_sigma2 * valid * robust.huber_weight(chi2, huber_delta)
        free_obs = free[obs_pose]
        Jp6 = J_pose6 * free_obs[:, None, None]

        Hd = jnp.zeros((n_dim, n_dim), dtype)
        bvec = jnp.zeros((n_dim,), dtype)

        Hpp6 = jnp.zeros((K, 6, 6), dtype).at[obs_pose].add(
            jnp.einsum("nia,n,nib->nab", Jp6, w, Jp6))
        bp6 = jnp.zeros((K, 6), dtype).at[obs_pose].add(
            jnp.einsum("nia,n,ni->na", Jp6, w, r_v))
        Hll = jnp.zeros((M, 3, 3), dtype).at[obs_lm].add(
            jnp.einsum("nia,n,nib->nab", J_X, w, J_X))
        bl = jnp.zeros((M, 3), dtype).at[obs_lm].add(
            jnp.einsum("nia,n,ni->na", J_X, w, r_v))
        Eob = jnp.einsum("nia,n,nib->nab", Jp6, w, J_X)  # (O, 6, 3)

        # ---------------- inertial edges --------------------------------
        r_i, J_i = inertial_jacobians(R_all, p_all, v_all, b_all)
        chi2_i = jnp.sum(r_i * r_i, -1)
        w_i = edge_mask * robust.huber_weight(
            chi2_i, jnp.sqrt(jnp.asarray(CHI2_INERTIAL, dtype)))
        JtJ_e = jnp.einsum("eia,e,eib->eab", J_i, w_i, J_i)   # (E,24,24)
        Jtr_e = jnp.einsum("eia,e,ei->ea", J_i, w_i, r_i)
        Hd = Hd.at[all_edge_cols[:, :, None],
                   all_edge_cols[:, None, :]].add(JtJ_e)
        bvec = bvec.at[all_edge_cols].add(Jtr_e)

        if not shared_bias:
            # Bias random-walk edges: linear, J = [-W_rw | W_rw].
            r_rw = (b_all[edge_j] - b_all[edge_i]) * w_rw     # (E, 6)
            Wd = w_rw * edge_mask[:, None] ** 0.5
            Jrw = jnp.concatenate([
                -jax.vmap(jnp.diag)(Wd), jax.vmap(jnp.diag)(Wd)], axis=-1)
            JtJ_rw = jnp.einsum("eia,eib->eab", Jrw, Jrw)
            Jtr_rw = jnp.einsum("eia,ei->ea", Jrw,
                                r_rw * edge_mask[:, None] ** 0.5)
            Hd = Hd.at[rw_cols[:, :, None], rw_cols[:, None, :]].add(JtJ_rw)
            bvec = bvec.at[rw_cols].add(Jtr_rw)

        # ---------------- bias priors ------------------------------------
        pr = jnp.concatenate([jnp.full(3, prior_gyro, dtype),
                              jnp.full(3, prior_acc, dtype)])
        pcols = bias_src * 15 + jnp.arange(9, 15)
        Hd = Hd.at[pcols, pcols].add(pr)
        bvec = bvec.at[pcols].add(pr * b_all[bias_src])

        # ---------------- assemble + damp ---------------------------------
        eye3 = jnp.eye(3, dtype=dtype)
        Hll_d = Hll + lam * (eye3[None] + Hll * eye3[None])
        Hll_inv = jnp.linalg.inv(Hll_d) * lm_mask[:, None, None]

        # Dense cross block (K, M, 6, 3) — K is a temporal window, small.
        Wc = jnp.zeros((K, M, 6, 3), dtype).at[obs_pose, obs_lm].add(Eob)
        Wi = jnp.einsum("kmab,mbc->kmac", Wc, Hll_inv)
        corr = jnp.einsum("kmac,lmbc->kalb", Wi, Wc).reshape(6 * K, 6 * K)
        rhs_corr = jnp.einsum("kmab,mb->ka", Wi, bl).reshape(-1)

        Hd = Hd.at[pose_dims[:, None], pose_dims[None, :]].add(
            _embed_blockdiag(Hpp6) - corr)
        bvec = bvec.at[pose_dims].add(bp6.reshape(-1) - rhs_corr)

        diag = jnp.diagonal(Hd)
        Hd = Hd + jnp.diag(lam * (1.0 + diag) + 1e-8)

        # Freeze fixed dims: identity rows/cols (pose dims from `fixed`,
        # velocity/bias dims from `fixed_vb`).
        fixd = jnp.where(jnp.tile(jnp.arange(15) < 6, K),
                         jnp.repeat(fixed, 15), jnp.repeat(fvb, 15))
        Hd = Hd * (1 - fixd)[:, None] * (1 - fixd)[None, :] + jnp.diag(fixd)
        bvec = bvec * (1 - fixd)

        dx = -jnp.linalg.solve(Hd, bvec).reshape(K, 15)
        dp6 = dx[:, :6].reshape(-1)
        dl = -jnp.einsum("mab,mb->ma", Hll_inv,
                         bl + jnp.einsum("kmab,ka->mb", Wc, dx[:, :6]))

        # ---------------- apply + accept/reject ---------------------------
        R_new = jax.vmap(lambda Rk, ph: normalize_rotation(Rk @ exp_so3(ph)))(
            R_all, dx[:, 0:3])
        p_new = p_all + dx[:, 3:6]
        v_new = v_all + dx[:, 6:9]
        b_new = b_all + dx[:, 9:15]
        X_new = X_all + dl * lm_mask[:, None]

        cost_new = full_cost(R_new, p_new, v_new, b_new, X_new)
        accept = cost_new < cost_prev
        R_all = jnp.where(accept, R_new, R_all)
        p_all = jnp.where(accept, p_new, p_all)
        v_all = jnp.where(accept, v_new, v_all)
        b_all = jnp.where(accept, b_new, b_all)
        X_all = jnp.where(accept, X_new, X_all)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7),
                        jnp.minimum(lam * 5.0, 1e4))
        cost = jnp.where(accept, cost_new, cost_prev)
        return (R_all, p_all, v_all, b_all, X_all, lam, cost), cost

    def _embed_blockdiag(Hb):
        out = jnp.zeros((K, 6, K, 6), dtype)
        out = out.at[jnp.arange(K), :, jnp.arange(K), :].set(Hb)
        return out.reshape(6 * K, 6 * K)

    cost0 = full_cost(R_wb, p_wb, v_w, bias, X)
    init = (R_wb, p_wb, v_w, bias, X,
            jnp.asarray(init_lambda, dtype), cost0)
    (R_f, p_f, v_f, b_f, X_f, _, cost_f), _ = jax.lax.scan(
        lm_step, init, None, length=n_iters)
    r_v, _, _, _ = vis_terms_clean(R_f, p_f, X_f)
    chi2_f = jnp.sum(r_v * r_v, -1) * robust.octave_inv_sigma2(obs_level)
    return R_f, p_f, v_f, b_f, X_f, chi2_f, cost_f
