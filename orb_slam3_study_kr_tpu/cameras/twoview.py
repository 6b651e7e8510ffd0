"""Monocular two-view initialization: batched RANSAC over homography and
fundamental hypotheses, model selection, and motion recovery.

Batched re-design of /root/reference/src/TwoViewReconstruction.cc: instead
of 200 sequential RANSAC iterations each touching 8 points, all 200
hypotheses are built with one batched SVD and scored against all N matches
as one (T, N) computation; the 4 essential / 8 Faugeras homography motion
candidates are verified by one batched triangulation each.  Thresholds
mirror the reference (chi2 5.991 / 3.841 at sigma = 1, model select
RH = SH/(SH+SF) > 0.50, cheirality + parallax gating in CheckRT).
"""

from functools import partial

import jax
import jax.numpy as jnp

from orb_slam3_study_kr_tpu.lie.so3 import hat
from orb_slam3_study_kr_tpu.ops.geometry import triangulate_dlt

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991  # both models accumulate (SCORE_TH - chi2)
RANSAC_ITERS = 200
MIN_TRIANGULATED = 50
MIN_PARALLAX_DEG = 1.0
COS_PARALLAX_INF = 0.99998  # points beyond this parallax treated as infinite


def _normalize_points(kp, mask):
    """Zero-mean / unit mean-abs-dev normalization (DLT conditioning)."""
    n = jnp.maximum(jnp.sum(mask), 1.0)
    mean = jnp.sum(kp * mask[:, None], axis=0) / n
    d = jnp.abs(kp - mean) * mask[:, None]
    mean_dev = jnp.sum(d, axis=0) / n
    s = 1.0 / jnp.maximum(mean_dev, 1e-8)
    kp_n = (kp - mean) * s
    T = jnp.array(
        [[s[0], 0.0, -mean[0] * s[0]], [0.0, s[1], -mean[1] * s[1]], [0.0, 0.0, 1.0]],
        kp.dtype,
    )
    return kp_n, T


def _sample_minimal_sets(key, mask, iters, k=8):
    """(iters, k) indices of valid matches, sampled without replacement."""
    n = mask.shape[0]
    u = jax.random.uniform(key, (iters, n))
    u = jnp.where(mask[None, :] > 0, u, 2.0)
    return jnp.argsort(u, axis=1)[:, :k]


def _homography_dlt(p1, p2):
    """H21 from k point pairs (x2 ~ H x1): p1, p2 (..., k, 2) normalized."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    rows_a = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], axis=-1)
    rows_b = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=-1)
    A = jnp.concatenate([rows_a, rows_b], axis=-2)  # (..., 2k, 9)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    h = Vt[..., 8, :]
    return h.reshape(*h.shape[:-1], 3, 3)


def _fundamental_8pt(p1, p2):
    """F21 (x2^T F x1 = 0) from 8 pairs, rank-2 enforced."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = jnp.ones_like(x1)
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], axis=-1
    )  # (..., 8, 9)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    F = Vt[..., 8, :].reshape(*A.shape[:-2], 3, 3)
    U, S, Vt2 = jnp.linalg.svd(F)
    S = S.at[..., 2].set(0.0)
    return U @ (S[..., :, None] * Vt2)


def _refit_homography(kp1n, kp2n, w):
    """Least-squares H21 over all weighted correspondences via the 9x9
    normal matrix (smallest-eigenvector); one extra solve that lifts the
    minimal-set estimate to an all-inlier estimate."""
    x1, y1 = kp1n[:, 0], kp1n[:, 1]
    x2, y2 = kp2n[:, 0], kp2n[:, 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    ra = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], axis=-1)
    rb = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=-1)
    A = jnp.concatenate([ra * w[:, None], rb * w[:, None]], axis=0)
    M = A.T @ A
    _, V = jnp.linalg.eigh(M)
    return V[:, 0].reshape(3, 3)


def _refit_fundamental(kp1n, kp2n, w):
    x1, y1 = kp1n[:, 0], kp1n[:, 1]
    x2, y2 = kp2n[:, 0], kp2n[:, 1]
    o = jnp.ones_like(x1)
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], axis=-1
    ) * w[:, None]
    M = A.T @ A
    _, V = jnp.linalg.eigh(M)
    F = V[:, 0].reshape(3, 3)
    U, S, Vt = jnp.linalg.svd(F)
    S = S.at[2].set(0.0)
    return U @ (S[:, None] * Vt)


def _score_homography(H21, kp1, kp2, mask, sigma2):
    """Symmetric transfer error score, (T,) given H21 (T, 3, 3)."""
    H12 = jnp.linalg.inv(H21)

    def transfer(H, src, dst):
        x, y = src[..., 0], src[..., 1]
        w = H[..., 2, 0][..., None] * x + H[..., 2, 1][..., None] * y + H[..., 2, 2][..., None]
        w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
        u = (H[..., 0, 0][..., None] * x + H[..., 0, 1][..., None] * y + H[..., 0, 2][..., None]) / w
        v = (H[..., 1, 0][..., None] * x + H[..., 1, 1][..., None] * y + H[..., 1, 2][..., None]) / w
        return (dst[..., 0] - u) ** 2 + (dst[..., 1] - v) ** 2

    chi2_12 = transfer(H21, kp1[None], kp2[None]) / sigma2  # x2 vs H21 x1
    chi2_21 = transfer(H12, kp2[None], kp1[None]) / sigma2
    in1 = chi2_12 < CHI2_H
    in2 = chi2_21 < CHI2_H
    score = jnp.where(in1, SCORE_TH - chi2_12, 0.0) + jnp.where(in2, SCORE_TH - chi2_21, 0.0)
    score = jnp.sum(score * mask[None], axis=-1)
    inliers = in1 & in2 & (mask[None] > 0)
    return score, inliers


def _score_fundamental(F21, kp1, kp2, mask, sigma2):
    """Epipolar-distance score, (T,) given F21 (T, 3, 3)."""

    def epi_dist2(F, src, dst):
        # line l = F [src; 1] in dst image
        x, y = src[..., 0], src[..., 1]
        a = F[..., 0, 0][..., None] * x + F[..., 0, 1][..., None] * y + F[..., 0, 2][..., None]
        b = F[..., 1, 0][..., None] * x + F[..., 1, 1][..., None] * y + F[..., 1, 2][..., None]
        c = F[..., 2, 0][..., None] * x + F[..., 2, 1][..., None] * y + F[..., 2, 2][..., None]
        num = a * dst[..., 0] + b * dst[..., 1] + c
        return num * num / jnp.maximum(a * a + b * b, 1e-12)

    chi2_2 = epi_dist2(F21, kp1[None], kp2[None]) / sigma2
    Ft = jnp.swapaxes(F21, -1, -2)
    chi2_1 = epi_dist2(Ft, kp2[None], kp1[None]) / sigma2
    in2 = chi2_2 < CHI2_F
    in1 = chi2_1 < CHI2_F
    score = jnp.where(in2, SCORE_TH - chi2_2, 0.0) + jnp.where(in1, SCORE_TH - chi2_1, 0.0)
    score = jnp.sum(score * mask[None], axis=-1)
    inliers = in1 & in2 & (mask[None] > 0)
    return score, inliers


def _check_rt(R21, t21, xn1, xn2, kp1, kp2, K, inliers, sigma2):
    """Count triangulated points passing cheirality / parallax / reprojection,
    mirroring TwoViewReconstruction::CheckRT (:66h, CheckRT in .cc).

    xn1, xn2: (N, 2) normalized (bearing) coords; kp1, kp2 pixel coords.
    Returns (n_good, parallax_deg, pts3d (N, 3) in cam1 frame, good mask).
    """
    eye = jnp.eye(3, dtype=R21.dtype)
    zero = jnp.zeros(3, dtype=R21.dtype)
    pw = triangulate_dlt(xn1, xn2, eye[None], zero[None], R21[None], t21[None])
    finite = jnp.all(jnp.isfinite(pw), axis=-1)
    pw = jnp.where(finite[:, None], pw, 0.0)

    c1 = zero
    c2 = -R21.T @ t21
    r1 = pw - c1
    r2 = pw - c2
    n1 = jnp.linalg.norm(r1, axis=-1)
    n2 = jnp.linalg.norm(r2, axis=-1)
    cos_par = jnp.sum(r1 * r2, axis=-1) / jnp.maximum(n1 * n2, 1e-12)

    z1 = pw[:, 2]
    p2 = jnp.einsum("ij,nj->ni", R21, pw) + t21
    z2 = p2[:, 2]
    # Both depths must be positive for finite points; the infinite-parallax
    # escape mirrors the reference's cosParallax < 0.99998 guard.
    depth_ok = ((z1 > 0) & (z2 > 0)) | (cos_par >= COS_PARALLAX_INF)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z1s = jnp.where(jnp.abs(z1) < 1e-12, 1e-12, z1)
    z2s = jnp.where(jnp.abs(z2) < 1e-12, 1e-12, z2)
    u1 = fx * pw[:, 0] / z1s + cx
    v1 = fy * pw[:, 1] / z1s + cy
    u2 = fx * p2[:, 0] / z2s + cx
    v2 = fy * p2[:, 1] / z2s + cy
    err1 = (u1 - kp1[:, 0]) ** 2 + (v1 - kp1[:, 1]) ** 2
    err2 = (u2 - kp2[:, 0]) ** 2 + (v2 - kp2[:, 1]) ** 2
    reproj_ok = (err1 < 4.0 * sigma2) & (err2 < 4.0 * sigma2)

    good = inliers & finite & depth_ok & reproj_ok
    n_good = jnp.sum(good)

    # Parallax statistic: 50th-smallest cos among good points (reference takes
    # sorted index min(50, n-1)).
    cos_masked = jnp.where(good & (cos_par < COS_PARALLAX_INF), cos_par, 1.0)
    cos_sorted = jnp.sort(cos_masked)
    idx = jnp.minimum(50, jnp.maximum(n_good - 1, 0))
    cos_at = cos_sorted[idx]
    parallax_deg = jnp.degrees(jnp.arccos(jnp.clip(cos_at, -1.0, 1.0)))
    return n_good, parallax_deg, pw, good


def _refine_essential(E0, xn1, xn2, w, iters=8, damping=1e-4):
    """Gauss-Newton polish of the essential matrix over all inliers,
    minimizing Sampson error.  The linear 8-point estimate leaves ~0.3 deg of
    rotation error at realistic noise, which the reference tolerates by
    retrying initialization; one tiny batched GN solve (6x6) removes it.

    E is parameterized through (R, t) from its own decomposition; Sampson
    error is invariant to the scale of E, the gauge direction is absorbed by
    LM damping."""
    from orb_slam3_study_kr_tpu.lie.so3 import exp_so3

    U, _, Vt = jnp.linalg.svd(E0)
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E0.dtype)
    R0 = U @ W @ Vt
    t0 = U[:, 2]

    x1h = jnp.concatenate([xn1, jnp.ones_like(xn1[:, :1])], axis=-1)
    x2h = jnp.concatenate([xn2, jnp.ones_like(xn2[:, :1])], axis=-1)

    def sampson(params):
        wR, wt = params[:3], params[3:]
        R = R0 @ exp_so3(wR)
        t = t0 + wt
        E = hat(t) @ R
        Ex1 = x1h @ E.T  # (N, 3)
        Etx2 = x2h @ E  # (N, 3)
        num = jnp.sum(x2h * Ex1, axis=-1)
        denom = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
        return num / jnp.sqrt(jnp.maximum(denom, 1e-12))

    def step(params, _):
        r = sampson(params)
        J = jax.jacfwd(sampson)(params)  # (N, 6)
        Jw = J * w[:, None]
        H = Jw.T @ J + damping * jnp.eye(6, dtype=E0.dtype)
        g = Jw.T @ r
        delta = jnp.linalg.solve(H, g)
        return params - delta, None

    params, _ = jax.lax.scan(step, jnp.zeros(6, E0.dtype), None, length=iters)
    wR, wt = params[:3], params[3:]
    R = R0 @ exp_so3(wR)
    t = t0 + wt
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    return hat(t) @ R


def _decompose_essential(E):
    """E -> (R1, R2, t): the four candidate motions are (R1,t),(R1,-t),(R2,t),(R2,-t)."""
    U, _, Vt = jnp.linalg.svd(E)
    # Ensure proper rotations.
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    return R1, R2, t


def _decompose_homography_faugeras(Hn):
    """8 candidate (R, t, n) motions from a calibrated homography
    (Faugeras & Lustman 1988, the same decomposition ReconstructH uses).

    Returns R (8, 3, 3), t (8, 3) (unit norm)."""
    U, d, Vt = jnp.linalg.svd(Hn)
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]

    denom = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    aux1 = jnp.sqrt(jnp.clip((d1 * d1 - d2 * d2) / denom, 0.0, None))
    aux3 = jnp.sqrt(jnp.clip((d2 * d2 - d3 * d3) / denom, 0.0, None))
    e1 = jnp.array([1.0, 1.0, -1.0, -1.0])
    e3 = jnp.array([1.0, -1.0, 1.0, -1.0])
    x1 = e1 * aux1
    x3 = e3 * aux3

    # Case d' = d2
    aux_st = jnp.sqrt(
        jnp.clip((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0, None)
    ) / jnp.maximum((d1 + d3) * d2, 1e-12)
    ct = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    st = jnp.stack([aux_st, -aux_st, -aux_st, aux_st])

    def build_pos(ct, st, x1, x3):
        Rp = jnp.array(
            [[ct, 0.0, -st], [0.0, 1.0, 0.0], [st, 0.0, ct]], Hn.dtype
        )
        tp = (d1 - d3) * jnp.array([x1, 0.0, -x3], Hn.dtype)
        return Rp, tp

    # Case d' = -d2
    aux_sp = jnp.sqrt(
        jnp.clip((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0, None)
    ) / jnp.maximum((d1 - d3) * d2, 1e-12)
    cp = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    sp = jnp.stack([aux_sp, -aux_sp, -aux_sp, aux_sp])

    def build_neg(cp, sp, x1, x3):
        Rp = jnp.array(
            [[cp, 0.0, sp], [0.0, -1.0, 0.0], [sp, 0.0, -cp]], Hn.dtype
        )
        tp = (d1 + d3) * jnp.array([x1, 0.0, x3], Hn.dtype)
        return Rp, tp

    Rs, ts = [], []
    for i in range(4):
        Rp, tp = build_pos(ct, st[i], x1[i], x3[i])
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ tp)
    for i in range(4):
        Rp, tp = build_neg(cp, sp[i], x1[i], x3[i])
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ tp)
    R = jnp.stack(Rs)
    t = jnp.stack(ts)
    t = t / jnp.maximum(jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    return R, t


@partial(jax.jit, static_argnames=("iters",))
def reconstruct_two_views(key, kp1, kp2, mask, K, sigma=1.0, iters=RANSAC_ITERS):
    """Full monocular bootstrap.

    Args:
      key: PRNG key for RANSAC sampling.
      kp1, kp2: (N, 2) matched undistorted pixel keypoints in frames 1, 2.
      mask: (N,) 1.0 for valid matches.
      K: (3, 3) intrinsics.

    Returns dict with:
      success: bool scalar (clear-winner criteria of ReconstructF/H).
      R21, t21: pose of frame2 w.r.t. frame1 (world = frame1 camera).
      pts3d: (N, 3) triangulated points in frame-1 camera coords.
      good: (N,) bool triangulation validity.
      used_homography: bool scalar.
    """
    sigma2 = sigma * sigma
    n = kp1.shape[0]

    kp1n, T1 = _normalize_points(kp1, mask)
    kp2n, T2 = _normalize_points(kp2, mask)
    T2inv = jnp.linalg.inv(T2)

    kh, kf = jax.random.split(key)
    idx_h = _sample_minimal_sets(kh, mask, iters)
    idx_f = _sample_minimal_sets(kf, mask, iters)

    # --- Homography hypotheses ---
    p1h = kp1n[idx_h]  # (T, 8, 2)
    p2h = kp2n[idx_h]
    Hn_hyp = _homography_dlt(p1h, p2h)  # normalized-coord H21
    H21_hyp = T2inv[None] @ Hn_hyp @ T1[None]
    h_scores, h_inliers = _score_homography(H21_hyp, kp1, kp2, mask, sigma2)
    h_best = jnp.argmax(h_scores)
    h_inl0 = h_inliers[h_best]
    # Re-fit on all inliers of the best hypothesis, keep whichever scores
    # higher (guards against a degenerate refit).
    Hn_refit = _refit_homography(kp1n, kp2n, h_inl0.astype(kp1.dtype))
    H21_refit = T2inv @ Hn_refit @ T1
    h_score_r, h_inl_r = _score_homography(H21_refit[None], kp1, kp2, mask, sigma2)
    better_h = h_score_r[0] > h_scores[h_best]
    SH = jnp.where(better_h, h_score_r[0], h_scores[h_best])
    H21 = jnp.where(better_h, H21_refit, H21_hyp[h_best])
    h_inl = jnp.where(better_h, h_inl_r[0], h_inl0)

    # --- Fundamental hypotheses ---
    p1f = kp1n[idx_f]
    p2f = kp2n[idx_f]
    Fn_hyp = _fundamental_8pt(p1f, p2f)
    F21_hyp = jnp.swapaxes(T2, -1, -2)[None] @ Fn_hyp @ T1[None]
    f_scores, f_inliers = _score_fundamental(F21_hyp, kp1, kp2, mask, sigma2)
    f_best = jnp.argmax(f_scores)
    f_inl0 = f_inliers[f_best]
    Fn_refit = _refit_fundamental(kp1n, kp2n, f_inl0.astype(kp1.dtype))
    F21_refit = jnp.swapaxes(T2, -1, -2) @ Fn_refit @ T1
    f_score_r, f_inl_r = _score_fundamental(F21_refit[None], kp1, kp2, mask, sigma2)
    better_f = f_score_r[0] > f_scores[f_best]
    SF = jnp.where(better_f, f_score_r[0], f_scores[f_best])
    F21 = jnp.where(better_f, F21_refit, F21_hyp[f_best])
    f_inl = jnp.where(better_f, f_inl_r[0], f_inl0)

    use_h = SH / jnp.maximum(SH + SF, 1e-12) > 0.50

    # Normalized bearings for triangulation.
    Kinv = jnp.linalg.inv(K)
    xn1 = (kp1 - jnp.array([K[0, 2], K[1, 2]])) / jnp.array([K[0, 0], K[1, 1]])
    xn2 = (kp2 - jnp.array([K[0, 2], K[1, 2]])) / jnp.array([K[0, 0], K[1, 1]])

    # --- Motion candidates: pack 4 essential + 8 homography into 12 and
    # verify all with one vmapped CheckRT; select within the chosen family.
    E21 = K.T @ F21 @ K
    E21 = _refine_essential(E21, xn1, xn2, f_inl.astype(kp1.dtype))
    R1e, R2e, te = _decompose_essential(E21)
    R_ess = jnp.stack([R1e, R1e, R2e, R2e])
    t_ess = jnp.stack([te, -te, te, -te])

    Hn_cal = Kinv @ H21 @ K
    R_hom, t_hom = _decompose_homography_faugeras(Hn_cal)

    R_all = jnp.concatenate([R_ess, R_hom], axis=0)  # (12, 3, 3)
    t_all = jnp.concatenate([t_ess, t_hom], axis=0)  # (12, 3)
    fam_inl = jnp.where(use_h, h_inl, f_inl)

    n_good, par_deg, pts, goods = jax.vmap(
        lambda R, t: _check_rt(R, t, xn1, xn2, kp1, kp2, K, fam_inl, sigma2)
    )(R_all, t_all)

    fam_mask = jnp.where(
        use_h,
        jnp.concatenate([jnp.zeros(4, bool), jnp.ones(8, bool)]),
        jnp.concatenate([jnp.ones(4, bool), jnp.zeros(8, bool)]),
    )
    n_good_m = jnp.where(fam_mask, n_good, -1)
    best = jnp.argmax(n_good_m)
    best_good = n_good_m[best]
    second = jnp.sort(n_good_m)[-2]

    n_inl = jnp.sum(fam_inl)
    min_good = jnp.maximum(jnp.int32(0.9 * n_inl), MIN_TRIANGULATED)

    # Clear-winner test: reference requires a unique hypothesis within 0.75x
    # of the best (F path: nsimilar == 1; H path: second < 0.75 * best).
    ok = (
        (best_good >= min_good)
        & (second.astype(jnp.float32) < 0.75 * best_good.astype(jnp.float32))
        & (par_deg[best] > MIN_PARALLAX_DEG)
    )

    return dict(
        success=ok,
        R21=R_all[best],
        t21=t_all[best],
        pts3d=pts[best],
        good=goods[best],
        n_good=best_good,
        used_homography=use_h,
        parallax_deg=par_deg[best],
        score_h=SH,
        score_f=SF,
    )
