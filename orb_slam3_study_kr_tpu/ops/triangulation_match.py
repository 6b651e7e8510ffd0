"""Epipolar-constrained matching + triangulation between two keyframes.

Replaces ORBmatcher::SearchForTriangulation + the gating core of
LocalMapping::CreateNewMapPoints (/root/reference/src/LocalMapping.cc:398):
one masked Hamming problem per keyframe pair (epipolar distance gate in
place of the BoW node walk), one batched ray triangulation, and the
reference's acceptance gates (parallax, cheirality, reprojection chi2
5.991 x sigma2, scale-band consistency) as masks.

Camera-generic: observations enter as raw pixel coords `uv` PLUS bearing
vectors `b` (unprojected rays), and reprojection runs through `project_fn`
— so the same op serves ideal-pinhole and Kannala-Brandt fisheye frames
(where the reference special-cases via GeometricCamera::epipolarConstrain
and KannalaBrandt8::TriangulateMatches, KannalaBrandt8.cpp).  The epipolar
pre-gate is the bearing-plane distance scaled to pixel units by `focal`;
rays beyond 90 degrees off-axis remain valid.
"""

import functools

import jax
import jax.numpy as jnp

from orb_slam3_study_kr_tpu.ops.geometry import triangulate_rays
from orb_slam3_study_kr_tpu.ops.matching import BIG, TH_LOW, hamming_matrix
from orb_slam3_study_kr_tpu.lie.so3 import hat

CHI2_MONO = 5.991
EPI_CHI2 = 3.84          # epipolar gate (Pinhole.cpp:128)
MIN_PARALLAX_COS = 0.9998  # LocalMapping.cc:608 cosParallaxRays gate


@functools.partial(jax.jit, static_argnames=("project_fn",))
def match_and_triangulate(
    R1, t1, R2, t2, project_fn, focal,
    uv1, b1, level1, desc1, free1,
    uv2, b2, level2, desc2, free2,
    angle1=None, angle2=None,
    scale_factor=1.2,
    epi_chi2=EPI_CHI2,
    nn_ratio=0.9,
):
    """Match free keypoints of KF1 against KF2 along epipolar planes and
    triangulate the accepted pairs.

    Args:
      project_fn: camera-frame points (..., 3) -> pixels (..., 2).
      focal: scalar focal length used to express angular epipolar distance
        in pixel-equivalent units for the chi2 gate.
      uv1, uv2: (N, 2) pixel coords in the native image (raw for fisheye).
      b1, b2: (N, 3) bearing vectors for each keypoint.

    Returns dict with per-kp1 arrays:
      idx2 (N1,), matched (N1,), X (N1, 3) world points, good (N1,).
    """
    b1n = b1 / jnp.maximum(jnp.linalg.norm(b1, axis=-1, keepdims=True), 1e-12)
    b2n = b2 / jnp.maximum(jnp.linalg.norm(b2, axis=-1, keepdims=True), 1e-12)

    # Essential matrix with b1^T E b2 = 0 (GeometricTools::ComputeF12 core).
    R12 = R1 @ R2.T
    t12 = t1 - R12 @ t2
    E = hat(t12) @ R12
    # Epipolar plane normal of each kp1 in camera 2: l2 = E^T b1.
    l2 = b1n @ E  # (N1, 3)
    l2 = l2 / jnp.maximum(jnp.linalg.norm(l2, axis=-1, keepdims=True), 1e-12)
    sin_d = jnp.einsum("ac,bc->ab", l2, b2n)  # (N1, N2) sine of plane dist
    d2 = (focal * focal) * sin_d * sin_d      # pixel-equivalent squared
    sigma2_2 = scale_factor ** (2.0 * level2.astype(jnp.float32))
    epi_ok = d2 < epi_chi2 * sigma2_2[None, :]

    mask = epi_ok & free1[:, None] & free2[None, :]
    dist = hamming_matrix(desc1, desc2)
    d = jnp.where(mask, dist, BIG)
    idx2 = jnp.argmin(d, axis=1)
    best = jnp.min(d, axis=1)
    dd = jnp.where(jax.nn.one_hot(idx2, d.shape[1], dtype=bool), BIG, d)
    second = jnp.min(dd, axis=1)
    matched = (best <= TH_LOW) & (best < nn_ratio * second)
    # Mutual best to avoid two kp1 claiming one kp2.
    back = jnp.argmin(d, axis=0)
    matched = matched & (back[idx2] == jnp.arange(uv1.shape[0]))
    if angle1 is not None:
        from orb_slam3_study_kr_tpu.ops.matching import rotation_consistency
        matched = rotation_consistency(angle1, angle2, idx2, matched)

    # Triangulate matched pairs from rays (fisheye-safe DLT).
    b2m = b2n[idx2]
    X = triangulate_rays(b1n, b2m, R1[None], t1[None], R2[None], t2[None])

    # Gates of CreateNewMapPoints:
    c1 = -R1.T @ t1
    c2 = -R2.T @ t2
    r1v = X - c1
    r2v = X - c2
    n1 = jnp.linalg.norm(r1v, axis=-1)
    n2 = jnp.linalg.norm(r2v, axis=-1)
    cos_par = jnp.sum(r1v * r2v, axis=-1) / jnp.maximum(n1 * n2, 1e-12)
    p1 = jnp.einsum("ij,nj->ni", R1, X) + t1
    p2 = jnp.einsum("ij,nj->ni", R2, X) + t2
    # Cheirality along the observed ray (for pinhole this is z > 0; for
    # fisheye it stays correct past 90 degrees off-axis).
    z_ok = (jnp.sum(p1 * b1n, axis=-1) > 0) & (jnp.sum(p2 * b2m, axis=-1) > 0)

    uv2m = uv2[idx2]
    e1 = jnp.sum((project_fn(p1) - uv1) ** 2, axis=-1)
    e2 = jnp.sum((project_fn(p2) - uv2m) ** 2, axis=-1)
    sigma2_1 = scale_factor ** (2.0 * level1.astype(jnp.float32))
    reproj_ok = (e1 < CHI2_MONO * sigma2_1) & (e2 < CHI2_MONO * sigma2_2[idx2])

    # Scale consistency: distance ratio vs octave ratio within 1.5x.
    ratio_dist = n2 / jnp.maximum(n1, 1e-9)
    ratio_oct = scale_factor ** (
        level1.astype(jnp.float32) - level2[idx2].astype(jnp.float32)
    )
    sc_ok = (ratio_dist < ratio_oct * 1.5) & (ratio_dist * 1.5 > ratio_oct)

    good = (
        matched
        & z_ok
        & (cos_par < MIN_PARALLAX_COS)
        & (cos_par > 0)
        & reproj_ok
        & sc_ok
        & jnp.all(jnp.isfinite(X), axis=-1)
    )
    return dict(idx2=idx2, matched=matched, X=X, good=good, cos_par=cos_par)


@functools.partial(jax.jit, static_argnames=("project_fn",))
def match_and_triangulate_batch(
    R1, t1, R2s, t2s, project_fn, focal,
    uv1, b1, level1, desc1, free1,
    uv2s, b2s, level2s, desc2s, free2s,
    angle1, angle2s,
    scale_factor=1.2,
    epi_chi2=EPI_CHI2,
    nn_ratio=0.9,
):
    """All-neighbors triangulation in ONE program: vmap of
    match_and_triangulate over the neighbor axis (leading axis of the
    *2s arrays), sharing the kf-side arrays.  One dispatch + one fetch
    replaces a per-neighbor program chain — the per-neighbor matmuls
    run as one batched product instead of serializing.  Pad unused neighbor slots
    with free2=False rows (they produce no matches)."""

    def one(R2, t2, uv2, b2, level2, desc2, free2, angle2):
        out = match_and_triangulate(
            R1, t1, R2, t2, project_fn, focal,
            uv1, b1, level1, desc1, free1,
            uv2, b2, level2, desc2, free2,
            angle1=angle1, angle2=angle2,
            scale_factor=scale_factor, epi_chi2=epi_chi2,
            nn_ratio=nn_ratio)
        return out["idx2"], out["X"], out["good"]

    idx2, X, good = jax.vmap(one)(R2s, t2s, uv2s, b2s, level2s, desc2s,
                                  free2s, angle2s)
    return dict(idx2=idx2, X=X, good=good)
