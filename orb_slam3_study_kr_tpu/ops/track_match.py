"""Projection-guided matching for tracking (the SearchByProjection family).

Replaces the grid-bucket walks of ORBmatcher::SearchByProjection
(/root/reference/include/ORBmatcher.h:47-63) with one dense masked Hamming
problem per call: project every candidate landmark with the predicted pose,
build the (L, N) gate mask (frustum, distance band, viewing angle, predicted
scale, search radius), add it to the Hamming matrix, and resolve matches
keypoint-wise so duplicates cannot occur.

Gate constants mirror Tracking/ORBmatcher: distance band [0.8 min, 1.2 max],
viewing-angle cos > 0.5, radius 2.5 / 4.0 by view angle (x th), per-level
radius scaling, TH_HIGH = 100 acceptance.
"""

import functools

import jax
import jax.numpy as jnp

from orb_slam3_study_kr_tpu.ops.matching import BIG, TH_HIGH, hamming_matrix

VIEW_COS_LIMIT = 0.5


@functools.partial(jax.jit, static_argnames=("project_fn",))
def project_landmarks(
    project_fn, R_cw, t_cw,
    lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_mask,
    width, height, scale_factor=1.2, n_levels=8, max_theta_deg=None,
):
    """Frustum + band + view-angle visibility (Frame::isInFrustum) and
    predicted level (MapPoint::PredictScale) for all landmarks at once.

    `max_theta_deg`: optional off-axis limit replacing the pinhole z > 0
    frustum gate for wide-FOV lenses (KB8: pass half the lens FOV, so
    points past 90 deg off-axis stay visible — the reference routes this
    through GeometricCamera-aware isInFrustum for fisheye frames).

    Returns (uv (L, 2), visible (L,), pred_level (L,), view_cos (L,))."""
    p = jnp.einsum("ij,lj->li", R_cw, lm_pos) + t_cw
    if max_theta_deg is None:
        z_ok = p[:, 2] > 0.01
    else:
        r_xy = jnp.linalg.norm(p[:, :2], axis=-1)
        theta = jnp.arctan2(r_xy, p[:, 2])
        z_ok = (theta < jnp.radians(max_theta_deg)) & (
            jnp.linalg.norm(p, axis=-1) > 1e-3)
    uv = project_fn(p)
    in_img = (
        (uv[:, 0] >= 0) & (uv[:, 0] < width) & (uv[:, 1] >= 0) & (uv[:, 1] < height)
    )
    center = -R_cw.T @ t_cw
    vec = lm_pos - center
    dist = jnp.linalg.norm(vec, axis=-1)
    band = (dist >= 0.8 * lm_min_dist) & (dist <= 1.2 * lm_max_dist)
    view_cos = jnp.sum(vec * lm_normal, axis=-1) / jnp.maximum(dist, 1e-9)
    angle_ok = view_cos > VIEW_COS_LIMIT
    visible = z_ok & in_img & band & angle_ok & (lm_mask > 0)
    ratio = lm_max_dist / jnp.maximum(dist, 1e-9)
    pred = jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-9)) / jnp.log(scale_factor))
    pred = jnp.clip(pred, 0, n_levels - 1).astype(jnp.int32)
    return uv, visible, pred, view_cos


@functools.partial(jax.jit, static_argnames=("project_fn",))
def match_local_map(
    project_fn, R_cw, t_cw,
    lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_desc, lm_mask,
    f_uv, f_level, f_desc, f_valid,
    width, height, th=1.0, nn_ratio=0.8, scale_factor=1.2, n_levels=8,
    level_slack=1, max_dist=TH_HIGH, max_theta_deg=None,
):
    """SearchByProjection(Frame, vector<MapPoint*>, th): track-local-map.

    Returns per-keypoint (lm_slot (N,), ok (N,), visible (L,)) where lm_slot
    indexes the lm_* arrays passed in."""
    uv_proj, visible, pred, view_cos = project_landmarks(
        project_fn, R_cw, t_cw, lm_pos, lm_normal, lm_min_dist, lm_max_dist,
        lm_mask, width, height, scale_factor, n_levels, max_theta_deg,
    )
    # Radius: 2.5 px if well-aligned view else 4.0, times th, times the
    # predicted level's scale (ORBmatcher::RadiusByViewingCos).
    base_r = jnp.where(view_cos > 0.998, 2.5, 4.0) * th
    radius = base_r * scale_factor ** pred.astype(jnp.float32)

    d_uv = jnp.abs(uv_proj[:, None, :] - f_uv[None, :, :])
    in_window = (d_uv[..., 0] <= radius[:, None]) & (d_uv[..., 1] <= radius[:, None])
    lvl = f_level[None, :] - pred[:, None]
    lvl_ok = (lvl >= -level_slack) & (lvl <= level_slack)
    mask = in_window & lvl_ok & visible[:, None] & f_valid[None, :]

    dist = hamming_matrix(lm_desc, f_desc)  # (L, N)
    d = jnp.where(mask, dist, BIG)
    # Keypoint-wise best landmark (prevents duplicate bindings).
    lm_slot = jnp.argmin(d, axis=0)
    best = jnp.min(d, axis=0)
    dd = jnp.where(
        jax.nn.one_hot(lm_slot, d.shape[0], dtype=bool).T, BIG, d
    )
    second = jnp.min(dd, axis=0)
    ok = (best <= max_dist) & (best < nn_ratio * second) & f_valid
    # Enforce one keypoint per landmark (a MapPoint binds at most one
    # keypoint per frame in the reference): among keypoints that picked the
    # same landmark keep the lowest-distance one, index as tie-break.
    n = f_uv.shape[0]
    key = jnp.where(
        ok,
        best * (n + 1) + jnp.arange(n, dtype=best.dtype),
        BIG,
    )
    min_key = jnp.full((lm_pos.shape[0],), BIG, key.dtype).at[lm_slot].min(key)
    ok = ok & (key <= min_key[lm_slot])
    return lm_slot, ok, visible


@functools.partial(jax.jit, static_argnames=(
    "project_fn", "n_levels", "level_slack"))
def match_local_map_batch(
    project_fn, R_cws, t_cws,
    lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_desc, lm_masks,
    f_uvs, f_levels, f_descs, f_valids,
    width, height, th=1.0, nn_ratio=0.8, scale_factor=1.2, n_levels=8,
    level_slack=1, max_dist=100.0, max_theta_deg=None,
):
    """Fuse-style projection matching of ONE shared landmark block into
    MANY target keyframes in a single program: vmap of match_local_map
    over the leading (neighbor) axis of R_cws/t_cws/lm_masks/f_*.
    Replaces a per-neighbor dispatch chain (SearchInNeighbors,
    LocalMapping.cc:743) with one dispatch + one fetch; pad unused
    neighbor slots with lm_mask=0 / f_valid=False rows."""

    def one(R, t, lm_mask, f_uv, f_level, f_desc, f_valid):
        return match_local_map(
            project_fn, R, t,
            lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_desc, lm_mask,
            f_uv, f_level, f_desc, f_valid,
            width, height, th=th, nn_ratio=nn_ratio,
            scale_factor=scale_factor, n_levels=n_levels,
            level_slack=level_slack, max_dist=max_dist,
            max_theta_deg=max_theta_deg)

    return jax.vmap(one)(R_cws, t_cws, lm_masks, f_uvs, f_levels, f_descs,
                         f_valids)


@jax.jit
def match_by_descriptor(
    q_desc, q_valid, t_desc, t_valid, max_dist=50.0, nn_ratio=0.75,
):
    """Unconstrained descriptor matching with ratio + mutual check — the
    dense stand-in for SearchByBoW (the BoW feature-vector constraint is an
    acceleration structure, not a behavior; as one matmul the full matrix
    is cheap).  Used for reference-keyframe tracking and relocalization."""
    dist = hamming_matrix(q_desc, t_desc)
    mask = q_valid[:, None] & t_valid[None, :]
    d = jnp.where(mask, dist, BIG)
    idx = jnp.argmin(d, axis=1)
    best = jnp.min(d, axis=1)
    dd = jnp.where(jax.nn.one_hot(idx, d.shape[1], dtype=bool), BIG, d)
    second = jnp.min(dd, axis=1)
    ok = (best <= max_dist) & (best < nn_ratio * second)
    back = jnp.argmin(d, axis=0)
    ok = ok & (back[idx] == jnp.arange(idx.shape[0]))
    return idx, ok, best
