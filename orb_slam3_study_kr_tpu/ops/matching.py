"""Binary-descriptor matching: Hamming distance matrices as matmuls plus the
reference's gate stack (distance thresholds, Lowe ratio, rotation-consistency
histogram, windowed search masks, mutual-best checks).

Replaces /root/reference/src/ORBmatcher.cc.  Where the reference walks
per-keypoint grid buckets and compares packed descriptors with popcount one
pair at a time, here descriptors are kept unpacked as (N, 256) {0,1} bytes
and a whole (N1, N2) Hamming matrix is one bf16 matmul:

    hamming(a, b) = popcount(a XOR b) = sum(a) + sum(b) - 2 a.b

so the 256-wide inner product is one matrix product, and every search
window / scale / rotation gate becomes a mask added to the distance matrix.

Thresholds mirror ORBmatcher.cc:35-37: TH_HIGH = 100, TH_LOW = 50,
HISTO_LENGTH = 30 rotation bins with top-3 retention.
"""

import functools

import jax
import jax.numpy as jnp

TH_HIGH = 100.0
TH_LOW = 50.0
HISTO_LENGTH = 30
BIG = 1e9


def hamming_matrix(desc1, desc2):
    """(N1, 256) x (N2, 256) uint8 {0,1} -> (N1, N2) float32 Hamming."""
    a = desc1.astype(jnp.bfloat16)
    b = desc2.astype(jnp.bfloat16)
    dot = jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    s1 = jnp.sum(desc1, axis=1).astype(jnp.float32)
    s2 = jnp.sum(desc2, axis=1).astype(jnp.float32)
    return s1[:, None] + s2[None, :] - 2.0 * dot


def masked_nn(dist, mask, max_dist=TH_LOW, nn_ratio=None):
    """Row-wise nearest neighbor under a boolean mask.

    Returns (match_idx (N1,), match_dist (N1,), ok (N1,)).  `nn_ratio`
    applies the reference's best < ratio * second-best test (computed over
    the same masked candidate set)."""
    d = jnp.where(mask, dist, BIG)
    idx = jnp.argmin(d, axis=1)
    best = jnp.take_along_axis(d, idx[:, None], axis=1)[:, 0]
    ok = best <= max_dist
    if nn_ratio is not None:
        d2 = jnp.where(
            jax.nn.one_hot(idx, d.shape[1], dtype=bool), BIG, d
        )
        second = jnp.min(d2, axis=1)
        ok = ok & (best < nn_ratio * second)
    return idx, best, ok


def mutual_best(idx12, ok12, idx21):
    """Cross-check: keep matches where row i's best j maps back to i."""
    back = idx21[idx12]
    return ok12 & (back == jnp.arange(idx12.shape[0]))


def rotation_consistency(angle1, angle2, idx, ok):
    """Three-maxima rotation histogram filter (ORBmatcher::ComputeThreeMaxima,
    applied by every SearchBy* that enables mbCheckOrientation).

    Keeps only matches whose angular difference falls into one of the 3
    most-populated of 30 bins (a bin must also hold >= 0.1x the max bin)."""
    rot = angle1 - angle2[idx]
    rot = jnp.where(rot < 0, rot + 2 * jnp.pi, rot)
    bin_f = rot * (HISTO_LENGTH / (2 * jnp.pi))
    bins = jnp.clip(jnp.round(bin_f).astype(jnp.int32), 0, HISTO_LENGTH) % HISTO_LENGTH
    counts = jnp.sum(
        jax.nn.one_hot(bins, HISTO_LENGTH, dtype=jnp.float32) * ok[:, None].astype(jnp.float32),
        axis=0,
    )
    top3 = jax.lax.top_k(counts, 3)[0]
    keep_bin = (counts[bins] >= top3[2]) & (counts[bins] > 0.1 * top3[0])
    return ok & keep_bin


def window_mask(uv1, uv2, radius):
    """(N1, N2) mask: |uv2 - uv1| within a square radius (grid-search
    equivalent of Frame::GetFeaturesInArea)."""
    d = jnp.abs(uv1[:, None, :] - uv2[None, :, :])
    r = jnp.broadcast_to(jnp.asarray(radius), (uv1.shape[0],))
    return (d[..., 0] <= r[:, None]) & (d[..., 1] <= r[:, None])


def scale_band_mask(level1, level2, min_delta=-1, max_delta=1):
    """(N1, N2) mask over octave compatibility (SearchByProjection checks
    candidate level in [predicted-1, predicted+1])."""
    d = level2[None, :] - level1[:, None]
    return (d >= min_delta) & (d <= max_delta)


@functools.partial(jax.jit, static_argnames=("check_rotation", "mutual"))
def search_for_initialization(
    f1_uv, f1_desc, f1_angle, f1_valid,
    f2_uv, f2_desc, f2_angle, f2_valid,
    window_radius=100.0, nn_ratio=0.9, check_rotation=True, mutual=True,
):
    """Windowed descriptor matching between two frames for monocular
    initialization (ORBmatcher::SearchForInitialization: window search,
    TH_LOW, ratio test, rotation histogram).

    Returns (idx2 (N1,), ok (N1,), dist (N1,))."""
    dist = hamming_matrix(f1_desc, f2_desc)
    mask = (
        f1_valid[:, None]
        & f2_valid[None, :]
        & window_mask(f1_uv, f2_uv, window_radius)
    )
    idx, best, ok = masked_nn(dist, mask, TH_LOW, nn_ratio)
    if mutual:
        d_t = jnp.where(mask, dist, BIG).T
        idx21 = jnp.argmin(d_t, axis=1)
        ok = mutual_best(idx, ok, idx21)
    if check_rotation:
        ok = rotation_consistency(f1_angle, f2_angle, idx, ok)
    return idx, ok, best
