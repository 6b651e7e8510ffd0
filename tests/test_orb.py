"""ORB extraction + matching tests on synthetic rendered scenes.

Oracle style follows SURVEY.md section 4: golden-value kernel checks
(Hamming vs numpy popcount) plus behavioral checks (detection near true
corners, descriptor stability under rotation, cross-view matching)."""

import jax.numpy as jnp
import numpy as np
import pytest

from orb_slam3_study_kr_tpu.io import synthetic
from orb_slam3_study_kr_tpu.ops import matching, orb


@pytest.fixture(scope="module")
def scene_and_frames():
    rng = np.random.default_rng(3)
    scene = synthetic.make_scene(rng, n_points=400)
    R, t = synthetic.circular_trajectory(3, radius=0.8, span=0.15)
    frames = synthetic.render_sequence(scene, R, t, rng=rng)
    return scene, frames, R, t


CFG = orb.OrbConfig(n_features=1000)


def test_hamming_matrix_matches_numpy(rng):
    d1 = (rng.random((64, 256)) > 0.5).astype(np.uint8)
    d2 = (rng.random((96, 256)) > 0.5).astype(np.uint8)
    H = np.asarray(matching.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    ref = (d1[:, None, :] != d2[None, :, :]).sum(-1)
    np.testing.assert_array_equal(H.astype(np.int32), ref)


def test_fast_score_detects_blob_corners(scene_and_frames):
    _, frames, _, _ = scene_and_frames
    img = jnp.asarray(frames[0][0])
    s = orb.fast_score_map(img, 7.0)
    # Blobs are bright dots: their centers must score.
    assert float(jnp.max(s)) > 20
    assert int(jnp.sum(s > 0)) > 100


def test_extract_orb_finds_landmarks(scene_and_frames):
    scene, frames, _, _ = scene_and_frames
    img, uv_gt, vis = frames[0]
    feats = orb.extract_orb(jnp.asarray(img), CFG)
    kp = np.asarray(feats.uv)[np.asarray(feats.valid)]
    assert kp.shape[0] > 150, f"only {kp.shape[0]} keypoints"
    # Fraction of visible landmarks with a detected keypoint within 2 px.
    gt = uv_gt[vis]
    d = np.linalg.norm(gt[:, None, :] - kp[None, :, :], axis=-1).min(axis=1)
    frac = (d < 2.0).mean()
    assert frac > 0.5, f"only {frac:.2%} of landmarks detected"


def test_keypoints_spatially_spread(scene_and_frames):
    _, frames, _, _ = scene_and_frames
    feats = orb.extract_orb(jnp.asarray(frames[0][0]), CFG)
    kp = np.asarray(feats.uv)[np.asarray(feats.valid)]
    # At least 3 of 4 image quadrants must hold >10% of keypoints each.
    cx, cy = 752 / 2, 480 / 2
    quads = [
        ((kp[:, 0] < cx) & (kp[:, 1] < cy)).mean(),
        ((kp[:, 0] >= cx) & (kp[:, 1] < cy)).mean(),
        ((kp[:, 0] < cx) & (kp[:, 1] >= cy)).mean(),
        ((kp[:, 0] >= cx) & (kp[:, 1] >= cy)).mean(),
    ]
    assert sum(q > 0.10 for q in quads) >= 3, quads


def test_descriptor_rotation_stability(scene_and_frames):
    """Rotate the image 25 deg about its center: matched descriptors must
    stay close in Hamming distance (the point of the oriented BRIEF)."""
    from scipy.ndimage import rotate as nd_rotate

    _, frames, _, _ = scene_and_frames
    img = frames[0][0]
    ang = 25.0
    img_r = nd_rotate(img, ang, reshape=False, order=1, mode="nearest")
    f1 = orb.extract_orb(jnp.asarray(img), CFG)
    f2 = orb.extract_orb(jnp.asarray(img_r), CFG)
    # Ground-truth correspondence by rotating keypoint coords.
    c = np.array([752 / 2 - 0.5, 480 / 2 - 0.5])
    th = np.radians(ang)
    Rm = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    kp1 = np.asarray(f1.uv)
    kp1_in2 = (kp1 - c) @ Rm + c  # image rotated by +ang moves content by R^-1
    v1 = np.asarray(f1.valid)
    v2 = np.asarray(f2.valid)
    kp2 = np.asarray(f2.uv)
    d1 = np.asarray(f1.desc)
    d2 = np.asarray(f2.desc)
    hams = []
    for i in np.nonzero(v1)[0]:
        d = np.linalg.norm(kp2[v2] - kp1_in2[i], axis=-1)
        j = d.argmin()
        if d[j] < 2.0:
            jj = np.nonzero(v2)[0][j]
            hams.append((d1[i] != d2[jj]).sum())
    hams = np.array(hams)
    assert len(hams) > 50
    frac = (hams < 60).mean()
    assert frac > 0.6, f"rotation-stable fraction {frac:.2%}, median {np.median(hams)}"


def test_search_for_initialization(scene_and_frames):
    scene, frames, R, t = scene_and_frames
    f1 = orb.extract_orb(jnp.asarray(frames[0][0]), CFG)
    f2 = orb.extract_orb(jnp.asarray(frames[2][0]), CFG)
    idx, ok, dist = matching.search_for_initialization(
        f1.uv, f1.desc, f1.angle, f1.valid,
        f2.uv, f2.desc, f2.angle, f2.valid,
    )
    ok_np = np.asarray(ok)
    n_matches = ok_np.sum()
    assert n_matches > 80, f"only {n_matches} matches"
    # Validate against ground truth: both keypoints near the same landmark's
    # projection in their own frames.
    uv1_gt, vis1 = frames[0][1], frames[0][2]
    uv2_gt, vis2 = frames[2][1], frames[2][2]
    kp1 = np.asarray(f1.uv)
    kp2 = np.asarray(f2.uv)
    idx_np = np.asarray(idx)
    correct = 0
    checked = 0
    for i in np.nonzero(ok_np)[0]:
        d1 = np.linalg.norm(uv1_gt - kp1[i], axis=-1)
        lm1 = d1.argmin()
        if d1[lm1] > 2.0 or not vis1[lm1]:
            continue
        checked += 1
        if np.linalg.norm(uv2_gt[lm1] - kp2[idx_np[i]]) < 3.0:
            correct += 1
    assert checked > 50
    assert correct / checked > 0.8, f"precision {correct}/{checked}"


def test_extract_orb_jit_stability(scene_and_frames):
    """Two calls with same-shape inputs must not retrace (cache hit) and the
    outputs must be deterministic."""
    _, frames, _, _ = scene_and_frames
    img = jnp.asarray(frames[1][0])
    a = orb.extract_orb(img, CFG)
    b = orb.extract_orb(img, CFG)
    np.testing.assert_array_equal(np.asarray(a.uv), np.asarray(b.uv))
    np.testing.assert_array_equal(np.asarray(a.desc), np.asarray(b.desc))


def test_extract_orb_pallas_flag_equivalence():
    """Plain small-config extract_orb: a 3-level pyramid at 160x128 finds
    keypoints, keeps them inside the image and returns fixed shapes."""
    cfg = orb.OrbConfig(n_features=200, n_levels=3, height=128, width=160)
    img = jnp.asarray(np.random.default_rng(0).integers(
        0, 255, (128, 160)).astype(np.float32))
    f = orb.extract_orb(img, cfg)
    valid = np.asarray(f.valid)
    assert valid.shape == (cfg.total_slots,)
    assert np.asarray(f.desc).shape == (cfg.total_slots, 256)
    assert int(valid.sum()) > 50
    uv = np.asarray(f.uv)[valid]
    assert (uv >= 0).all() and (uv[:, 0] < 160).all() and (uv[:, 1] < 128).all()
