"""Multi-view geometry primitives: triangulation, fundamental/essential
matrices.

Replaces /root/reference/src/GeometricTools.cc (ComputeF12, Triangulate) with
batched closed forms: the SVD DLT runs over (N, 4, 4) stacks so thousands of
landmarks triangulate in one XLA call.
"""

import jax.numpy as jnp

from orb_slam3_study_kr_tpu.lie.so3 import hat


def triangulate_dlt(xn1, xn2, R1w, t1w, R2w, t2w):
    """Batched DLT triangulation.

    Args:
      xn1, xn2: (..., 2) normalized image coords (bearing x/z, y/z) in cams 1, 2.
      R1w, t1w / R2w, t2w: world->camera poses (broadcastable to (..., 3, 3)/(..., 3)).

    Returns:
      (..., 3) world points (least-squares ray intersection via SVD of the
      4x4 DLT system, same construction as GeometricTools::Triangulate).
    """
    P1 = jnp.concatenate([R1w, t1w[..., None]], axis=-1)  # (..., 3, 4)
    P2 = jnp.concatenate([R2w, t2w[..., None]], axis=-1)
    rows = [
        xn1[..., 0:1, None] * P1[..., 2:3, :] - P1[..., 0:1, :],
        xn1[..., 1:2, None] * P1[..., 2:3, :] - P1[..., 1:2, :],
        xn2[..., 0:1, None] * P2[..., 2:3, :] - P2[..., 0:1, :],
        xn2[..., 1:2, None] * P2[..., 2:3, :] - P2[..., 1:2, :],
    ]
    A = jnp.concatenate(rows, axis=-2)  # (..., 4, 4)
    _, _, Vt = jnp.linalg.svd(A)
    Xh = Vt[..., 3, :]
    w = Xh[..., 3]
    safe_w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return Xh[..., :3] / safe_w[..., None]


def triangulate_rays(b1, b2, R1w, t1w, R2w, t2w):
    """Batched triangulation from bearing RAYS (fisheye-safe).

    Unlike `triangulate_dlt` (which uses plane coordinates x/z, y/z and
    degenerates for rays near or beyond 90 degrees off-axis), this builds
    the full cross-product constraint [b]_x (R X + t) = 0 per camera —
    3 rows of rank 2 each, valid for any bearing direction — and solves the
    stacked (6, 4) homogeneous system by SVD.  This is the batched
    equivalent of KannalaBrandt8::TriangulateMatches' DLT
    (/root/reference/src/CameraModels/KannalaBrandt8.cpp:Triangulate).

    Args:
      b1, b2: (..., 3) bearing vectors (need not be unit or z=1).
      R1w, t1w / R2w, t2w: world->camera poses (broadcastable).

    Returns (..., 3) world points.
    """
    P1 = jnp.concatenate([R1w, t1w[..., None]], axis=-1)  # (..., 3, 4)
    P2 = jnp.concatenate([R2w, t2w[..., None]], axis=-1)
    b1n = b1 / jnp.maximum(jnp.linalg.norm(b1, axis=-1, keepdims=True), 1e-12)
    b2n = b2 / jnp.maximum(jnp.linalg.norm(b2, axis=-1, keepdims=True), 1e-12)
    A = jnp.concatenate([
        jnp.einsum("...ij,...jk->...ik", hat(b1n), P1),
        jnp.einsum("...ij,...jk->...ik", hat(b2n), P2),
    ], axis=-2)  # (..., 6, 4)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    Xh = Vt[..., 3, :]
    w = Xh[..., 3]
    safe_w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return Xh[..., :3] / safe_w[..., None]


def essential_from_pose(R12, t12):
    """E such that x2n^T E x1n = 0 for relative pose (R12, t12) mapping cam2
    coords into cam1: E = [t]_x R with (R, t) = cam1<-cam2... Convention:
    given pose of cam2 in cam1 frame is (R12, t12), E = hat(t12) @ R12 and
    the constraint is x1n^T E x2n = 0."""
    return hat(t12) @ R12


def fundamental_from_poses(K1, K2, R1w, t1w, R2w, t2w):
    """F12 with x1^T F12 x2 = 0 for pixel coords (reference
    GeometricTools::ComputeF12 convention)."""
    R12 = R1w @ jnp.swapaxes(R2w, -1, -2)
    t12 = t1w - jnp.einsum("...ij,...j->...i", R12, t2w)
    E = hat(t12) @ R12
    K1_inv_T = jnp.linalg.inv(K1).swapaxes(-1, -2)
    return K1_inv_T @ E @ jnp.linalg.inv(K2)


def reprojection_error(uv_obs, uv_proj):
    return jnp.linalg.norm(uv_obs - uv_proj, axis=-1)


def parallax_cos(pw, c1, c2):
    """Cosine of the angle subtended at world point pw by camera centers."""
    r1 = pw - c1
    r2 = pw - c2
    n1 = jnp.linalg.norm(r1, axis=-1)
    n2 = jnp.linalg.norm(r2, axis=-1)
    return jnp.sum(r1 * r2, axis=-1) / jnp.maximum(n1 * n2, 1e-12)
