"""Bundle adjustment as dense-block Levenberg-Marquardt with Schur
complement over landmarks.

Replaces g2o's BlockSolver_6_3 + OptimizationAlgorithmLevenberg as used by
Optimizer::LocalBundleAdjustment and GlobalBundleAdjustemnt
(/root/reference/src/Optimizer.cc:1116, :61).  The formulation here:

- observations are flat index arrays (pose_idx, landmark_idx, uv, level,
  mask) — the bipartite graph as COO, not pointers;
- residuals and the closed-form 2x6 / 2x3 Jacobians are one batched sweep;
- per-pose 6x6 and per-landmark 3x3 blocks come from segment-sums;
- landmark elimination inverts (M, 3, 3) blocks in batch, and the reduced
  camera system S = Hpp - W Hll^-1 W^T is assembled with one big einsum;
- the (6K, 6K) reduced solve is a dense Cholesky (K is a local-BA window);
- LM damping with accept/reject lives in the lax.scan carry.

The caller culls observations whose final chi2 exceeds the 5.991 gate, as
LocalBundleAdjustment does after its solve.
"""

import functools

import jax
import jax.numpy as jnp

from orb_slam3_study_kr_tpu.lie.se3 import exp_se3, se3_compose
from orb_slam3_study_kr_tpu.solvers import robust
from orb_slam3_study_kr_tpu.solvers.reproj import residual_and_jacobians


def _gather_obs(R_cw, t_cw, X, obs_pose, obs_lm):
    return R_cw[obs_pose], t_cw[obs_pose], X[obs_lm]


def _schur_pcg(Hpp_d, bp, Hll_inv, bl, E, obs_pose, obs_lm, fixed, n_cg,
               psum_fn=None):
    """Matrix-free solve of the reduced camera system S dp = rhs.

    S v = Hpp_d v - W Hll_inv W^T v is evaluated with two segment-sum
    sweeps over the observations (never materializing W); the block-Jacobi
    preconditioner uses the EXACT diagonal of S (each pose/landmark pair
    has at most one observation, so the diagonal correction is a single
    segment-sum of Y E^T).  With psum_fn set (shard_map context), partial
    segment results are all-reduced across devices — observations can be
    sharded by landmark with replicated poses."""
    K = Hpp_d.shape[0]
    M = Hll_inv.shape[0]
    dt = Hpp_d.dtype
    psum = psum_fn if psum_fn is not None else (lambda x: x)
    freeK = (1.0 - fixed)[:, None]

    Y = jnp.einsum("nab,nbc->nac", E, Hll_inv[obs_lm])   # (O, 6, 3)

    rhs = -(bp - psum(jnp.zeros((K, 6), dt).at[obs_pose].add(
        jnp.einsum("nab,nb->na", Y, bl[obs_lm]))))
    rhs = rhs * freeK

    Dk = Hpp_d - psum(jnp.zeros((K, 6, 6), dt).at[obs_pose].add(
        jnp.einsum("nab,ncb->nac", Y, E)))
    Dk = Dk * freeK[..., None] + jnp.eye(6, dtype=dt)[None] * fixed[:, None, None]
    Minv = jnp.linalg.inv(Dk)

    def matvec(v):
        v = v * freeK
        u = jnp.einsum("kab,kb->ka", Hpp_d, v)
        # Landmark-space segment sum stays LOCAL: each landmark's full
        # observation set lives on one device (blocks on other devices are
        # different landmarks), so only pose-space reductions are psum'd.
        tv = jnp.zeros((M, 3), dt).at[obs_lm].add(
            jnp.einsum("nab,na->nb", E, v[obs_pose]))
        z = jnp.einsum("mab,mb->ma", Hll_inv, tv)
        u2 = psum(jnp.zeros((K, 6), dt).at[obs_pose].add(
            jnp.einsum("nab,nb->na", E, z[obs_lm])))
        return (u - u2) * freeK

    x0 = jnp.zeros((K, 6), dt)
    r0 = rhs
    z0 = jnp.einsum("kab,kb->ka", Minv, r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)

    def cg_step(carry, _):
        x, r, p, rz = carry
        Ap = matvec(p)
        denom = jnp.sum(p * Ap)
        alpha = jnp.where(jnp.abs(denom) > 1e-20, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = jnp.einsum("kab,kb->ka", Minv, r)
        rz_new = jnp.sum(r * z)
        beta = jnp.where(jnp.abs(rz) > 1e-20, rz_new / rz, 0.0)
        p = z + beta * p
        return (x, r, p, rz_new), None

    (dp, _, _, _), _ = jax.lax.scan(cg_step, (x0, r0, p0, rz0), None,
                                    length=n_cg)
    return dp


@functools.partial(
    jax.jit,
    static_argnames=("project_fn", "project_jac_fn", "n_iters", "use_huber",
                     "assembly", "n_cg", "wide_fov"),
)
def bundle_adjust(
    project_fn, project_jac_fn,
    R_cw, t_cw, fixed,            # (K,3,3), (K,3), (K,) 1.0 = frozen pose
    X, lm_mask,                   # (M,3), (M,) 1.0 = live landmark
    obs_pose, obs_lm, obs_uv, obs_level, obs_mask,  # (O,) ... (O,2)
    n_iters: int = 10,
    use_huber: bool = True,
    init_lambda: float = 1e-4,
    obs_ur=None, bf=None,
    assembly: str = "dense",      # "dense" | "pcg"
    n_cg: int = 60,
    wide_fov: bool = False,       # fisheye: |p| > 0 cheirality, not z > 0
):
    """Returns (R_cw, t_cw, X, final_chi2 (O,), final_cost).

    With obs_ur (O,) and bf = fx * baseline, observations with obs_ur >= 0
    get the reference's third stereo residual row (EdgeStereoSE3ProjectXYZ)
    and the 3-dof chi2/Huber gate 7.815.

    assembly="dense" materializes the (K, M, 6, 3) cross block and builds
    the reduced camera system with one einsum — fastest for local-BA
    windows.  assembly="pcg" never forms the cross block: the reduced
    system is solved matrix-free with block-Jacobi-preconditioned conjugate
    gradients whose matvec is two segment-sum sweeps over the observations
    (O(O) work, O(K + M + O) memory) — this is what lets global BA run on
    arbitrarily large maps (the reference's g2o uses sparse Cholesky;
    iterative Schur is the dense-array equivalent)."""
    K = R_cw.shape[0]
    M = X.shape[0]
    inv_sigma2 = robust.octave_inv_sigma2(obs_level)
    if obs_ur is None:
        chi2_gate = robust.CHI2_MONO
    else:
        chi2_gate = jnp.where(obs_ur >= 0, robust.CHI2_STEREO,
                              robust.CHI2_MONO)
    huber_delta = jnp.sqrt(jnp.asarray(chi2_gate, R_cw.dtype))

    def compute(R_all, t_all, X_all):
        Ro, to, Xo = _gather_obs(R_all, t_all, X_all, obs_pose, obs_lm)
        r, J_pose, J_point, p = residual_and_jacobians(
            project_jac_fn, project_fn, Ro, to, Xo, obs_uv,
            ur_obs=obs_ur, bf=bf,
        )
        chi2 = jnp.sum(r * r, axis=-1) * inv_sigma2
        cheir = (jnp.linalg.norm(p, axis=-1) > 1e-3) if wide_fov \
            else (p[:, 2] > 1e-3)
        valid = obs_mask * lm_mask[obs_lm] * cheir
        w = inv_sigma2 * valid
        if use_huber:
            w = w * robust.huber_weight(chi2, huber_delta)
        cost = jnp.sum(
            jnp.where(
                use_huber,
                _huber_rho(chi2) * valid,
                chi2 * valid,
            )
        )
        return r, J_pose, J_point, w, chi2, cost, valid

    def _huber_rho(chi2):
        d2 = chi2_gate
        d = huber_delta
        r = jnp.sqrt(jnp.maximum(chi2, 1e-12))
        return jnp.where(chi2 <= d2, chi2, 2 * d * r - d2)

    def lm_step(carry, _):
        R_all, t_all, X_all, lam, cost_prev = carry
        r, J_pose, J_point, w, chi2, _, valid = compute(R_all, t_all, X_all)

        # Freeze fixed poses by zeroing their Jacobian contribution.
        free_pose = (1.0 - fixed)[obs_pose]
        Jp = J_pose * free_pose[:, None, None]

        # Per-pose and per-landmark blocks via segment sums.
        Hpp = jnp.zeros((K, 6, 6), R_cw.dtype).at[obs_pose].add(
            jnp.einsum("nia,n,nib->nab", Jp, w, Jp)
        )
        bp = jnp.zeros((K, 6), R_cw.dtype).at[obs_pose].add(
            jnp.einsum("nia,n,ni->na", Jp, w, r)
        )
        Hll = jnp.zeros((M, 3, 3), R_cw.dtype).at[obs_lm].add(
            jnp.einsum("nia,n,nib->nab", J_point, w, J_point)
        )
        bl = jnp.zeros((M, 3), R_cw.dtype).at[obs_lm].add(
            jnp.einsum("nia,n,ni->na", J_point, w, r)
        )
        E = jnp.einsum("nia,n,nib->nab", Jp, w, J_point)  # (O, 6, 3)

        eye3 = jnp.eye(3, dtype=R_cw.dtype)
        eye6 = jnp.eye(6, dtype=R_cw.dtype)
        Hll_d = Hll + lam * (eye3[None] + _diag3(Hll))
        Hpp_d = Hpp + lam * (eye6[None] + _diag6(Hpp))
        Hll_inv = jnp.linalg.inv(Hll_d)
        # Dead landmark slots: zero inverse so they never move.
        Hll_inv = Hll_inv * lm_mask[:, None, None]

        if assembly == "dense":
            # Dense cross-block W (K, M, 6, 3); Schur product as one einsum.
            W = jnp.zeros((K, M, 6, 3), R_cw.dtype).at[obs_pose, obs_lm].add(E)
            Wi = jnp.einsum("kmab,mbc->kmac", W, Hll_inv)
            S = -jnp.einsum("kmac,lmbc->kalb", Wi, W).reshape(6 * K, 6 * K)
            S = S + _blockdiag6(Hpp_d)
            rhs = -(bp - jnp.einsum("kmab,mb->ka", Wi, bl)).reshape(6 * K)
            # Fixed poses: force identity rows/cols (their b is already 0).
            fixd = jnp.repeat(fixed, 6)
            S = S * (1 - fixd)[:, None] * (1 - fixd)[None, :] + jnp.diag(fixd)
            dp = jnp.linalg.solve(S, rhs).reshape(K, 6)
        else:
            dp = _schur_pcg(Hpp_d, bp, Hll_inv, bl, E, obs_pose, obs_lm,
                            fixed, n_cg)

        # Back-substitution: (W^T dp)_m by segment-sum over observations.
        Wtdp = jnp.zeros((M, 3), R_cw.dtype).at[obs_lm].add(
            jnp.einsum("nab,na->nb", E, dp[obs_pose]))
        dl = -jnp.einsum("mab,mb->ma", Hll_inv, bl + Wtdp)

        dR, dt = exp_se3(dp)
        R_new, t_new = se3_compose(dR, dt, R_all, t_all)
        X_new = X_all + dl * lm_mask[:, None]

        _, _, _, _, _, cost_new, _ = compute(R_new, t_new, X_new)
        accept = cost_new < cost_prev
        R_all = jnp.where(accept, R_new, R_all)
        t_all = jnp.where(accept, t_new, t_all)
        X_all = jnp.where(accept, X_new, X_all)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7), jnp.minimum(lam * 4.0, 1e3))
        cost = jnp.where(accept, cost_new, cost_prev)
        return (R_all, t_all, X_all, lam, cost), cost

    def _diag3(Hb):
        return jnp.eye(3, dtype=Hb.dtype)[None] * Hb * jnp.eye(3, dtype=Hb.dtype)[None]

    def _diag6(Hb):
        return jnp.eye(6, dtype=Hb.dtype)[None] * Hb * jnp.eye(6, dtype=Hb.dtype)[None]

    def _blockdiag6(Hb):
        out = jnp.zeros((K, 6, K, 6), Hb.dtype)
        out = out.at[jnp.arange(K), :, jnp.arange(K), :].set(Hb)
        return out.reshape(6 * K, 6 * K)

    cost0 = compute(R_cw, t_cw, X)[5]
    init = (R_cw, t_cw, X, jnp.asarray(init_lambda, R_cw.dtype), cost0)
    (R_f, t_f, X_f, _, cost_f), _ = jax.lax.scan(lm_step, init, None, length=n_iters)
    rF = compute(R_f, t_f, X_f)
    return R_f, t_f, X_f, rF[4], cost_f
