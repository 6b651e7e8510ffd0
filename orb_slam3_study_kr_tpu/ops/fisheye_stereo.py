"""Fisheye (non-rectified) stereo matching + ray triangulation.

Replaces Frame::ComputeStereoFishEyeMatches (/root/reference/src/
Frame.cc:1131) and KannalaBrandt8::TriangulateMatches
(/root/reference/include/CameraModels/KannalaBrandt8.h:86): rectification
is impossible for 195-degree lenses, so left/right keypoints are matched
by descriptor (the reference walks shared BoW nodes; as one matmul the full
Hamming matrix is cheaper), pre-gated by the epipolar plane of the known
extrinsic, triangulated from bearing rays, and accepted by two-sided
reprojection chi2 — exactly the reference's <=1e-1 sigma-scaled check.

One jitted call per frame; output is the camera-frame 3-D point per left
keypoint (the reference's mvStereo3Dpoints) + a validity mask.
"""

import functools

import jax
import jax.numpy as jnp

from orb_slam3_study_kr_tpu.lie.so3 import hat
from orb_slam3_study_kr_tpu.ops.geometry import triangulate_rays
from orb_slam3_study_kr_tpu.ops.matching import (BIG, TH_LOW, hamming_matrix,
                                                 rotation_consistency)

CHI2_MONO = 5.991


@functools.partial(jax.jit, static_argnames=("project_l_fn", "project_r_fn"))
def match_stereo_fisheye(
    project_l_fn, project_r_fn, focal,
    R_rl, t_rl,
    uv_l, b_l, level_l, desc_l, valid_l, angle_l,
    uv_r, b_r, level_r, desc_r, valid_r, angle_r,
    scale_factor=1.2,
    epi_chi2=9.0,
    nn_ratio=0.9,
):
    """Match left keypoints to right keypoints and triangulate.

    Args:
      project_l_fn / project_r_fn: KB8 projections of each camera.
      focal: pixel scale for the angular epipolar pre-gate.
      R_rl, t_rl: pose of the LEFT camera in the RIGHT camera frame
        (p_r = R_rl p_l + t_rl — the reference's Tlr inverse, so `t_rl`
        is minus the baseline through R_rl).
      uv/b/level/desc/valid/angle per side; b are unprojected bearings.

    Returns dict with per-left-kp arrays:
      idx_r (N,), ok (N,), X (N, 3) LEFT-camera-frame points,
      depth (N,) range along the left ray.
    """
    b_ln = b_l / jnp.maximum(jnp.linalg.norm(b_l, axis=-1, keepdims=True), 1e-12)
    b_rn = b_r / jnp.maximum(jnp.linalg.norm(b_r, axis=-1, keepdims=True), 1e-12)

    # Epipolar plane pre-gate: b_r^T E b_l = 0 with E = [t_rl]x R_rl.
    E = hat(t_rl) @ R_rl
    l_r = b_ln @ E.T  # (Nl, 3) plane normal in the right camera
    l_r = l_r / jnp.maximum(jnp.linalg.norm(l_r, axis=-1, keepdims=True), 1e-12)
    sin_d = jnp.einsum("ac,bc->ab", l_r, b_rn)  # (Nl, Nr)
    d2 = (focal * focal) * sin_d * sin_d
    sigma2_r = scale_factor ** (2.0 * level_r.astype(jnp.float32))
    epi_ok = d2 < epi_chi2 * sigma2_r[None, :]

    mask = epi_ok & valid_l[:, None] & valid_r[None, :]
    dist = hamming_matrix(desc_l, desc_r)
    d = jnp.where(mask, dist, BIG)
    idx_r = jnp.argmin(d, axis=1)
    best = jnp.min(d, axis=1)
    dd = jnp.where(jax.nn.one_hot(idx_r, d.shape[1], dtype=bool), BIG, d)
    second = jnp.min(dd, axis=1)
    matched = (best <= TH_LOW) & (best < nn_ratio * second)
    back = jnp.argmin(d, axis=0)
    matched = matched & (back[idx_r] == jnp.arange(uv_l.shape[0]))
    matched = rotation_consistency(angle_l, angle_r, idx_r, matched)

    # Triangulate in the LEFT camera frame: cam1 = left at identity,
    # cam2 = right at (R_rl, t_rl).
    eye = jnp.eye(3, dtype=b_l.dtype)
    zero = jnp.zeros(3, dtype=b_l.dtype)
    b_rm = b_rn[idx_r]
    X = triangulate_rays(b_ln, b_rm, eye[None], zero[None],
                         R_rl[None], t_rl[None])

    p_r = X @ R_rl.T + t_rl
    depth_l = jnp.sum(X * b_ln, axis=-1)          # range along the left ray
    depth_r = jnp.sum(p_r * b_rm, axis=-1)
    z_ok = (depth_l > 0) & (depth_r > 0)

    e_l = jnp.sum((project_l_fn(X) - uv_l) ** 2, axis=-1)
    e_r = jnp.sum((project_r_fn(p_r) - uv_r[idx_r]) ** 2, axis=-1)
    sigma2_l = scale_factor ** (2.0 * level_l.astype(jnp.float32))
    reproj_ok = (e_l < CHI2_MONO * sigma2_l) & (
        e_r < CHI2_MONO * sigma2_r[idx_r])

    ok = matched & z_ok & reproj_ok & jnp.all(jnp.isfinite(X), axis=-1)
    return dict(idx_r=idx_r, ok=ok, X=X, depth=depth_l)
