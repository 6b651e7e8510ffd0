"""Matching and the dense ORB stage against independent numpy references,
at deployment widths (752x480 levels; L=4096 landmarks x N=1024
keypoints)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage

from orb_slam3_study_kr_tpu.cameras import pinhole
from orb_slam3_study_kr_tpu.ops import matching, orb, track_match

BIG = matching.BIG


def _np_hamming(a, b):
    """Exact Hamming distances of {0,1} rows via a float64 product."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    return a.sum(1)[:, None] + b.sum(1)[None, :] - 2.0 * a @ b.T


def _np_fast_score(img, th):
    """FAST-9/16 score by definition: the largest margin t for which 9
    contiguous circle pixels are all brighter than c + t (or all darker
    than c - t); 0 below `th`.  Wraps at the image edge."""
    circle = np.stack([np.roll(img, (-dy, -dx), axis=(0, 1))
                       for dy, dx in orb.FAST_OFFSETS])
    score = np.zeros_like(img)
    for sign in (1.0, -1.0):
        d = sign * (circle - img[None])
        for j in range(16):
            arc = d[[(j + k) % 16 for k in range(9)]].min(axis=0)
            score = np.maximum(score, arc)
    return np.where(score > th, score, 0.0)


def _np_nms(score, margin):
    peak = ((score == ndimage.maximum_filter(score, 3, mode="wrap"))
            & (score > 0))
    h, w = score.shape
    ys, xs = np.mgrid[:h, :w]
    border = ((ys >= margin) & (ys < h - margin)
              & (xs >= margin) & (xs < w - margin))
    return np.where(peak & border, score, 0.0)


@pytest.mark.parametrize("level", [0, 3])
def test_dense_orb_stage_matches_numpy(level):
    """FAST score, NMS at both thresholds and the 7x7 blur of a full-width
    pyramid level; score and NMS are bit-exact on integer-valued input."""
    cfg = orb.OrbConfig()
    h, w = cfg.level_sizes[level]
    img = np.random.default_rng(level).integers(0, 255, (h, w)).astype(
        np.float32)
    s_raw, s20, s7, blur = (np.asarray(a) for a in orb._dense_stage(
        jnp.asarray(img), 7.0, 20.0, orb.EDGE_MARGIN - 3))
    ref = _np_fast_score(img, 7.0)
    np.testing.assert_array_equal(s_raw, ref)
    np.testing.assert_array_equal(s7, _np_nms(ref, orb.EDGE_MARGIN - 3))
    np.testing.assert_array_equal(
        s20, _np_nms(np.where(ref > 20.0, ref, 0.0), orb.EDGE_MARGIN - 3))
    k = np.exp(-0.5 * (np.arange(-3, 4) / 2.0) ** 2)
    k /= k.sum()
    ref_blur = ndimage.convolve1d(
        ndimage.convolve1d(img.astype(np.float64), k, axis=1, mode="nearest"),
        k, axis=0, mode="nearest")
    np.testing.assert_allclose(blur, ref_blur, atol=1e-3)


@pytest.mark.parametrize("case", ["dense", "all_invalid"])
def test_masked_nn_matches_numpy(case, rng):
    """Row-wise (argmin, best) and the ratio test of masked_nn over a real
    Hamming matrix; with every target masked nothing matches."""
    Q, T = 128, 1024
    q = (rng.random((Q, 256)) > 0.5).astype(np.uint8)
    t = (rng.random((T, 256)) > 0.5).astype(np.uint8)
    t[:Q] = np.where(rng.random((Q, 256)) < 0.05, 1 - q, q)
    valid = (rng.random(T) > 0.2) if case == "dense" else np.zeros(T, bool)
    mask = np.broadcast_to(valid[None, :], (Q, T))
    D = np.asarray(matching.hamming_matrix(jnp.asarray(q), jnp.asarray(t)))
    np.testing.assert_array_equal(D, _np_hamming(q, t))
    idx, best, ok = (np.asarray(a) for a in matching.masked_nn(
        jnp.asarray(D), jnp.asarray(mask), max_dist=50.0, nn_ratio=0.8))
    Dm = np.where(mask, _np_hamming(q, t), BIG)
    ref_idx = Dm.argmin(1)
    ref_best = Dm.min(1)
    D2 = Dm.copy()
    D2[np.arange(Q), ref_idx] = BIG
    ref_ok = (ref_best <= 50.0) & (ref_best < 0.8 * D2.min(1))
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(best, ref_best)
    np.testing.assert_array_equal(ok, ref_ok)
    if case == "all_invalid":
        assert not ok.any() and (best >= BIG).all()
    else:
        assert ok.sum() > Q // 2


def test_match_local_map_matches_numpy_bruteforce():
    """Track-local-map matching at L=4096, N=1024 against a numpy brute
    force with the same window / level / visibility gates, Lowe ratio and
    one-keypoint-per-landmark uniqueness."""
    rng = np.random.default_rng(5)
    L, N = 4096, 1024
    cam = jnp.asarray([458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0], jnp.float32)
    project_fn = functools.partial(pinhole.project, cam)
    lm_pos = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L),
                       rng.uniform(3, 9, L)], -1).astype(np.float32)
    normal = (lm_pos / np.linalg.norm(lm_pos, axis=-1, keepdims=True)
              ).astype(np.float32)
    lm_min = rng.uniform(0.5, 1.0, L).astype(np.float32)
    lm_max = rng.uniform(8, 20, L).astype(np.float32)
    lm_desc = (rng.random((L, 256)) < 0.5).astype(np.uint8)
    lm_mask = (rng.random(L) < 0.9).astype(np.float32)
    half = N // 2
    f_uv = rng.uniform(0, 752, (N, 2)).astype(np.float32)
    f_uv[:half] = (np.asarray(project_fn(jnp.asarray(lm_pos[:half])))
                   + rng.normal(0, 1.0, (half, 2)))
    f_desc = (rng.random((N, 256)) < 0.5).astype(np.uint8)
    flip = rng.random((half, 256)) < 0.03
    f_desc[:half] = np.where(flip, 1 - lm_desc[:half], lm_desc[:half])
    f_level = rng.integers(0, 8, N).astype(np.int32)
    f_valid = rng.random(N) < 0.95
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    args = [jnp.asarray(a) for a in (R, t, lm_pos, normal, lm_min, lm_max,
                                     lm_desc, lm_mask, f_uv, f_level, f_desc,
                                     f_valid)]
    th, slack = 3.0, 2
    slot, ok, vis = (np.asarray(a) for a in track_match.match_local_map(
        project_fn, *args, 752, 480, th=th, level_slack=slack))

    # Projection gates from their definition (Frame::isInFrustum) in f64.
    dist = np.linalg.norm(lm_pos.astype(np.float64), axis=-1)
    z = lm_pos[:, 2].astype(np.float64)
    u = 458.0 * lm_pos[:, 0] / z + 376.0
    v = 457.0 * lm_pos[:, 1] / z + 240.0
    view_cos = (lm_pos * normal).sum(-1) / dist
    ref_vis = ((z > 0.01) & (u >= 0) & (u < 752) & (v >= 0) & (v < 480)
               & (dist >= 0.8 * lm_min) & (dist <= 1.2 * lm_max)
               & (view_cos > 0.5) & (lm_mask > 0))
    pred = np.clip(np.ceil(np.log(lm_max / dist) / np.log(1.2)), 0, 7)
    radius = np.where(view_cos > 0.998, 2.5, 4.0) * th * 1.2 ** pred
    np.testing.assert_array_equal(vis, ref_vis)

    gate = ((np.abs(u[:, None] - f_uv[None, :, 0]) <= radius[:, None])
            & (np.abs(v[:, None] - f_uv[None, :, 1]) <= radius[:, None])
            & (np.abs(f_level[None, :] - pred[:, None]) <= slack)
            & ref_vis[:, None] & f_valid[None, :])
    D = np.where(gate, _np_hamming(lm_desc, f_desc), BIG)
    ref_slot = D.argmin(0)
    best = D.min(0)
    D[ref_slot, np.arange(N)] = BIG
    second = D.min(0)
    ref_ok = (best <= 100.0) & (best < 0.8 * second) & f_valid
    # One keypoint per landmark: the lowest (distance, keypoint index).
    for lm in np.unique(ref_slot[ref_ok]):
        kps = np.nonzero(ref_ok & (ref_slot == lm))[0]
        keep = kps[np.lexsort((kps, best[kps]))[0]]
        ref_ok[kps[kps != keep]] = False

    assert ref_ok.sum() > 150
    # f32 projection vs the f64 reference may flip a gate exactly at its
    # boundary; allow a handful of such keypoints, no systematic drift.
    assert (ok != ref_ok).sum() <= 3
    both = ok & ref_ok
    np.testing.assert_array_equal(slot[both], ref_slot[both])
