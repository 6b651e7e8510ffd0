"""ORB feature extraction as batched fixed-shape JAX.

Batched re-design of /root/reference/src/ORBextractor.cc.  Where the
reference walks 35-px cells sequentially calling OpenCV FAST and then
balances keypoints with a recursive quad-tree (DistributeOctTree,
ORBextractor.cc:877), this implementation computes dense per-pixel FAST
scores for the whole level in one vectorized elementwise pass (16 static
rolls), applies the same two-threshold fallback per cell as a masked
reduce, does 3x3 NMS, and approximates the quad-tree spatial balancing with
per-cell top-k followed by global top-quota selection — behavior match
(spatially spread, response-ranked keypoints), not algorithm match.

Orientation is the intensity-centroid of a radius-15 disc (IC_Angle,
ORBextractor.cc:76); descriptors are 256 rotated binary tests on the
7x7-Gaussian-blurred level (computeOrbDescriptor, ORBextractor.cc:107).
The test pattern is generated (BRIEF-style isotropic Gaussian, fixed seed)
rather than copied from the reference's learned table; descriptors only
need internal consistency since the vocabulary is trained on them too.

Static shapes everywhere: each pyramid level has a compile-time size and
keypoint quota; invalid slots carry response -inf and a valid=0 mask.
"""

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

# FAST-9/16 Bresenham circle of radius 3 (dy, dx), clockwise from 12 o'clock.
FAST_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    np.int32,
)

HALF_PATCH = 15  # orientation disc radius (reference HALF_PATCH_SIZE)
DESC_BITS = 256
PATTERN_RADIUS = 13  # generated pattern stays inside this disc
EDGE_MARGIN = 19  # reference EDGE_THRESHOLD


def _make_pattern(seed: int = 42) -> np.ndarray:
    """(256, 2, 2) int32 [point][p/q][y/x] binary-test offsets.

    BRIEF-style isotropic Gaussian sampling (sigma = patch/5), clipped to a
    disc so any rotation keeps samples inside the gathered patch."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < DESC_BITS * 2:
        p = rng.normal(0.0, 6.2, 2)
        if np.linalg.norm(p) <= PATTERN_RADIUS:
            pts.append(p)
    pat = np.array(pts[: DESC_BITS * 2]).reshape(DESC_BITS, 2, 2)
    return np.round(pat).astype(np.int32)


def _load_pattern() -> np.ndarray:
    """Use the trained rBRIEF-style pattern (greedy mean-0.5 / decorrelation
    selection over oriented patches, ORB paper sec. 4.3 method) when present,
    else the seeded Gaussian pattern."""
    import os

    path = os.path.join(os.path.dirname(__file__), "orb_pattern.npy")
    if os.path.exists(path):
        pat = np.load(path)
        if pat.shape == (DESC_BITS, 2, 2):
            return pat.astype(np.int32)
    return _make_pattern()


PATTERN = _load_pattern()


def _orientation_disc_mask() -> np.ndarray:
    """(31, 31) mask of the radius-15 disc (reference builds it via umax)."""
    yy, xx = np.mgrid[-HALF_PATCH : HALF_PATCH + 1, -HALF_PATCH : HALF_PATCH + 1]
    return (yy * yy + xx * xx <= HALF_PATCH * HALF_PATCH).astype(np.float32)


DISC_MASK = _orientation_disc_mask()


@dataclass(frozen=True)
class OrbConfig:
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: int = 20      # iniThFAST
    fast_min_threshold: int = 7   # minThFAST
    cell_size: int = 35
    cell_topk: int = 8            # candidates kept per cell before global top-quota
    height: int = 480
    width: int = 752

    @functools.cached_property
    def level_scales(self):
        return tuple(self.scale_factor ** l for l in range(self.n_levels))

    @functools.cached_property
    def level_sizes(self):
        return tuple(
            (int(round(self.height / s)), int(round(self.width / s)))
            for s in self.level_scales
        )

    @functools.cached_property
    def level_quotas(self):
        """Per-level keypoint budget, geometric in 1/scale_factor (the
        reference's nDesiredFeaturesPerScale schedule, ORBextractor.cc:409)."""
        f = 1.0 / self.scale_factor
        n0 = self.n_features * (1 - f) / (1 - f ** self.n_levels)
        quotas = [int(round(n0 * f ** l)) for l in range(self.n_levels - 1)]
        quotas.append(max(self.n_features - sum(quotas), 0))
        return tuple(quotas)

    @functools.cached_property
    def total_slots(self):
        return sum(self.level_quotas)


def fast_score_map(img, threshold_min: float):
    """Dense FAST-9/16 corner score for every pixel of (H, W) float image.

    Score = max threshold at which the pixel is still a corner: the max over
    the 16 contiguous 9-arcs of the arc-min of (p_i - c) for the bright
    polarity, and of (c - p_i) for the dark polarity (this equals OpenCV's
    threshold-based FAST score, which the reference relies on for NMS).
    Pixels below `threshold_min` score 0.
    """
    c = img
    circle = [jnp.roll(img, (-dy, -dx), axis=(0, 1)) for dy, dx in FAST_OFFSETS]
    circ = jnp.stack(circle, axis=0)  # (16, H, W)
    bright = circ - c[None]
    dark = -bright

    def arc_score(d):
        # d: (16, H, W) signed margins; result: max over 16 arcs of min-of-9.
        dd = jnp.concatenate([d, d[:8]], axis=0)  # (24, H, W)
        m = dd[:16]
        for k in range(1, 9):
            m = jnp.minimum(m, dd[k : k + 16])
        return jnp.max(m, axis=0)

    score = jnp.maximum(arc_score(bright), arc_score(dark))
    return jnp.where(score > threshold_min, score, 0.0)


def _nms3x3(score):
    neigh = -jnp.ones_like(score) * jnp.inf
    m = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh = jnp.maximum(neigh, jnp.roll(m, (dy, dx), axis=(0, 1)))
    return jnp.where((score >= neigh) & (score > 0), score, 0.0)


def _border_mask(h, w, margin):
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    return (
        (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)
    )


def select_keypoints(score20, score7, quota, cell, topk):
    """Two-threshold cell fallback + per-cell top-k + global top-quota.

    score20 / score7: NMS'd score maps at the high / low FAST threshold.
    Matches ComputeKeyPointsOctTree semantics: a cell uses the low threshold
    only when the high threshold found nothing there (ORBextractor.cc:826-846),
    and the quad-tree's keep-best-per-region balancing is approximated by
    per-cell top-k before the global response cut."""
    h, w = score20.shape
    ph = -(-h // cell) * cell
    pw = -(-w // cell) * cell
    s20 = jnp.pad(score20, ((0, ph - h), (0, pw - w)))
    s7 = jnp.pad(score7, ((0, ph - h), (0, pw - w)))
    ncy, ncx = ph // cell, pw // cell

    c20 = s20.reshape(ncy, cell, ncx, cell).transpose(0, 2, 1, 3).reshape(-1, cell * cell)
    c7 = s7.reshape(ncy, cell, ncx, cell).transpose(0, 2, 1, 3).reshape(-1, cell * cell)
    has20 = jnp.any(c20 > 0, axis=1, keepdims=True)
    cells = jnp.where(has20, c20, c7)  # (ncells, cell*cell)

    vals, idx = jax.lax.top_k(cells, topk)  # per-cell candidates
    # Recover absolute coordinates.
    cy = jnp.arange(ncy * ncx) // ncx
    cx = jnp.arange(ncy * ncx) % ncx
    yy = cy[:, None] * cell + idx // cell
    xx = cx[:, None] * cell + idx % cell

    flat_vals = vals.reshape(-1)
    flat_y = yy.reshape(-1)
    flat_x = xx.reshape(-1)
    q = min(quota, flat_vals.shape[0])
    top_vals, top_i = jax.lax.top_k(flat_vals, q)
    sel_y = flat_y[top_i]
    sel_x = flat_x[top_i]
    valid = top_vals > 0
    if q < quota:
        pad = quota - q
        top_vals = jnp.pad(top_vals, (0, pad))
        sel_y = jnp.pad(sel_y, (0, pad))
        sel_x = jnp.pad(sel_x, (0, pad))
        valid = jnp.pad(valid, (0, pad))
    return sel_x, sel_y, top_vals, valid


def subpixel_offset_maps(score_raw):
    """Dense parabolic 3x3 sub-pixel offset maps (dx, dy) of the (pre-NMS)
    score map — pure elementwise work; per-keypoint offsets are then
    two N-element gathers instead of five scalar gathers per keypoint.

    The reference keeps integer FAST corners; the ~0.3 px quantization that
    costs mono accuracy is cheap to remove here."""
    c = score_raw
    l = jnp.roll(c, 1, axis=1)
    r = jnp.roll(c, -1, axis=1)
    u = jnp.roll(c, 1, axis=0)
    d = jnp.roll(c, -1, axis=0)
    denx = 2.0 * c - l - r
    deny = 2.0 * c - u - d
    dx = jnp.where(jnp.abs(denx) > 1e-6, 0.5 * (r - l) / denx, 0.0)
    dy = jnp.where(jnp.abs(deny) > 1e-6, 0.5 * (d - u) / deny, 0.0)
    return jnp.clip(dx, -0.5, 0.5), jnp.clip(dy, -0.5, 0.5)


def subpixel_refine(score_raw, xs, ys):
    """Per-keypoint parabolic refinement (gathers from the dense maps)."""
    dx, dy = subpixel_offset_maps(score_raw)
    return (xs.astype(jnp.float32) + dx[ys, xs],
            ys.astype(jnp.float32) + dy[ys, xs])


def gather_patches(img, xs, ys, radius):
    """(N, 2r+1, 2r+1) patches centered at integer (ys, xs); the image is
    pre-padded so border keypoints gather safely."""
    p = 2 * radius + 1
    padded = jnp.pad(img, radius)

    def one(y, x):
        return jax.lax.dynamic_slice(padded, (y, x), (p, p))

    return jax.vmap(one)(ys, xs)


def compute_orientation(img, xs, ys):
    """Intensity-centroid angle (radians) per keypoint (IC_Angle)."""
    patches = gather_patches(img, xs, ys, HALF_PATCH)
    mask = jnp.asarray(DISC_MASK)
    coords = jnp.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=jnp.float32)
    m01 = jnp.sum(patches * mask[None] * coords[None, :, None], axis=(1, 2))
    m10 = jnp.sum(patches * mask[None] * coords[None, None, :], axis=(1, 2))
    return jnp.arctan2(m01, m10)


def gaussian_blur7(img, sigma: float = 2.0):
    """Separable 7x7 Gaussian (reference blurs with cv::GaussianBlur(7,7,2,2)
    before BRIEF sampling, ORBextractor.cc:1138)."""
    xs = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    k = jnp.asarray(k, img.dtype)
    pad = jnp.pad(img, 3, mode="edge")
    # Horizontal then vertical 1-D convolutions.
    h = sum(k[i] * pad[:, i : i + img.shape[1]] for i in range(7))
    h = h[3 : 3 + img.shape[0], :]
    hp = jnp.pad(h, ((3, 3), (0, 0)), mode="edge")
    v = sum(k[i] * hp[i : i + img.shape[0], :] for i in range(7))
    return v


def compute_descriptors(img_blur, xs, ys, angles):
    """(N, 256) uint8 {0,1} rotated-BRIEF bits.

    Sampling grid: pattern offsets rotated by the keypoint angle and rounded
    to integers, read from the blurred level — same scheme as
    computeOrbDescriptor (ORBextractor.cc:107) with a generated pattern."""
    radius = PATTERN_RADIUS + 2
    patches = gather_patches(img_blur, xs, ys, radius)  # (N, P, P)
    pat = jnp.asarray(PATTERN, jnp.float32)  # (256, 2, 2) [y, x]
    ca, sa = jnp.cos(angles), jnp.sin(angles)

    # Rotated integer offsets per keypoint: (N, 256, 2, 2)
    py, px = pat[..., 0], pat[..., 1]  # (256, 2)
    ry = jnp.round(px[None] * sa[:, None, None] + py[None] * ca[:, None, None])
    rx = jnp.round(px[None] * ca[:, None, None] - py[None] * sa[:, None, None])
    iy = (ry + radius).astype(jnp.int32)
    ix = (rx + radius).astype(jnp.int32)

    def one(patch, iy, ix):
        vals = patch[iy, ix]  # (256, 2)
        return (vals[:, 0] < vals[:, 1]).astype(jnp.uint8)

    return jax.vmap(one)(patches, iy, ix)


PATCH_R = 5  # oriented verification patch radius (11x11)

# Cross-level batched keypoint stage: one superpatch per keypoint covers
# the orientation disc (r=15), the rotated pattern reach (r<=13 + bilinear
# margin) and the oriented 11x11 patch (r=5*sqrt2+margin).
SUPER_R = 16
_SS = 2 * SUPER_R + 1


def _hat(d):
    """Bilinear interpolation kernel max(0, 1 - |d|)."""
    return jnp.maximum(0.0, 1.0 - jnp.abs(d))


def _gather_superpatches(stack, lvl, yi, xi):
    """(N, 33, 33) windows centered at level pixel (yi, xi) from a
    (L, H+2R, W+2R) stack whose level images sit at offset (+R, +R)."""

    def one(l, y, x):
        return jax.lax.dynamic_slice(stack, (l, y, x), (1, _SS, _SS))[0]

    return jax.vmap(one)(lvl, yi, xi)


def _orientation_from_patches(raw_sp):
    """Intensity-centroid angle from integer-centered superpatches
    (IC_Angle, ORBextractor.cc:76) — batched reduces, no gathers."""
    coords = jnp.arange(-SUPER_R, SUPER_R + 1, dtype=jnp.float32)
    rr = coords[:, None] ** 2 + coords[None, :] ** 2
    disc = (rr <= HALF_PATCH * HALF_PATCH).astype(jnp.float32)
    m01 = jnp.sum(raw_sp * disc[None] * coords[None, :, None], axis=(1, 2))
    m10 = jnp.sum(raw_sp * disc[None] * coords[None, None, :], axis=(1, 2))
    return jnp.arctan2(m01, m10)


def _sample_rotated(blur_sp, offs_y, offs_x, fy, fx, angles):
    """Bilinear samples of each superpatch at its keypoint-rotated offsets
    (+ the sub-pixel center fraction), as separable hat-weight
    contractions instead of per-element gathers (as in ops/klt.py).

    offs_y/offs_x: (P,) canonical offsets; returns (N, P) samples."""
    ca = jnp.cos(angles)[:, None]
    sa = jnp.sin(angles)[:, None]
    px = SUPER_R + fx[:, None] + offs_x[None] * ca - offs_y[None] * sa
    py = SUPER_R + fy[:, None] + offs_x[None] * sa + offs_y[None] * ca
    s_iota = jnp.arange(_SS, dtype=jnp.float32)
    A = _hat(py[..., None] - s_iota)              # (N, P, S)
    B = _hat(px[..., None] - s_iota)
    C = jnp.einsum("nps,nst->npt", A, blur_sp)    # rows interpolated in y
    return jnp.einsum("npt,npt->np", C, B)


def _descriptors_from_patches(blur_sp, fy, fx, angles):
    """(N, 256) uint8 rotated-BRIEF bits via one batched matmul sampling of
    the 512 pattern points (replaces the per-keypoint rounded-offset
    gathers; sampling is bilinear rather than nearest — descriptors stay
    self-consistent because matching uses this same extractor)."""
    pts = jnp.asarray(PATTERN.reshape(2 * DESC_BITS, 2), jnp.float32)
    vals = _sample_rotated(blur_sp, pts[:, 0], pts[:, 1], fy, fx, angles)
    vals = vals.reshape(-1, DESC_BITS, 2)
    return (vals[..., 0] < vals[..., 1]).astype(jnp.uint8)


def _oriented_patches_from_patches(blur_sp, fy, fx, angles, radius=PATCH_R):
    """(N, 11, 11) canonical-orientation patches at the refined center
    (gather_oriented_patches semantics, batched)."""
    grid = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    gy, gx = jnp.meshgrid(grid, grid, indexing="ij")
    vals = _sample_rotated(blur_sp, gy.ravel(), gx.ravel(), fy, fx, angles)
    p = 2 * radius + 1
    return vals.reshape(-1, p, p)


@dataclass(frozen=True)
class OrbFeatures:
    """SoA keypoint table in level-0 pixel coordinates (fixed capacity)."""
    uv: jnp.ndarray        # (N, 2) float32, level-0 coords
    response: jnp.ndarray  # (N,)
    angle: jnp.ndarray     # (N,) radians
    level: jnp.ndarray     # (N,) int32
    desc: jnp.ndarray      # (N, 256) uint8
    valid: jnp.ndarray     # (N,) bool
    patch: jnp.ndarray = None  # (N, 11, 11) uint8 oriented intensity patch


jax.tree_util.register_dataclass(
    OrbFeatures,
    data_fields=["uv", "response", "angle", "level", "desc", "valid", "patch"],
    meta_fields=[],
)


def gather_oriented_patches(img, xs, ys, angles, radius=PATCH_R):
    """(N, 2r+1, 2r+1) patches rotated to the keypoint's canonical
    orientation (bilinear sampling on the level image), for appearance
    verification and KLT alignment of matches (ops/klt.py)."""
    span = int(np.ceil(radius * 1.5)) + 2
    padded = jnp.pad(img, span)
    grid = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    gy, gx = jnp.meshgrid(grid, grid, indexing="ij")

    def one(x, y, a):
        ca, sa = jnp.cos(a), jnp.sin(a)
        px = x + gx * ca - gy * sa + span
        py = y + gx * sa + gy * ca + span
        x0 = jnp.floor(px)
        y0 = jnp.floor(py)
        wx = px - x0
        wy = py - y0
        x0 = x0.astype(jnp.int32)
        y0 = y0.astype(jnp.int32)
        v00 = padded[y0, x0]
        v01 = padded[y0, x0 + 1]
        v10 = padded[y0 + 1, x0]
        v11 = padded[y0 + 1, x0 + 1]
        return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
                + wy * ((1 - wx) * v10 + wx * v11))

    return jax.vmap(one)(xs.astype(jnp.float32), ys.astype(jnp.float32), angles)


def build_pyramid(img, cfg: OrbConfig):
    """List of n_levels float32 images; level l resized from level l-1
    (mirrors ComputePyramid's chained cv::resize)."""
    levels = [img.astype(jnp.float32)]
    for l in range(1, cfg.n_levels):
        h, w = cfg.level_sizes[l]
        levels.append(
            jax.image.resize(levels[-1], (h, w), method="linear")
        )
    return levels


def _dense_stage(img_l, th_min, th_ini, margin):
    """FAST score, border-masked 3x3 NMS at both thresholds, 7x7 blur."""
    s_raw = fast_score_map(img_l, th_min)
    s20 = jnp.where(s_raw > th_ini, s_raw, 0.0)
    border = _border_mask(*img_l.shape, margin)
    s20 = jnp.where(border, _nms3x3(s20), 0.0)
    s7 = jnp.where(border, _nms3x3(s_raw), 0.0)
    return s_raw, s20, s7, gaussian_blur7(img_l)


def extract_level(img_l, quota, cfg: OrbConfig):
    """Dense per-level stage: FAST score, two-threshold NMS, cell select,
    sub-pixel offsets (+ the level's 7x7 blur).  Per-keypoint work
    (orientation/descriptor/patch) happens once, batched across ALL
    levels, in extract_orb."""
    s_raw, s20, s7, blurred = _dense_stage(
        img_l, float(cfg.fast_min_threshold), float(cfg.fast_threshold),
        EDGE_MARGIN - 3)
    xs, ys, resp, valid = select_keypoints(
        s20, s7, quota, cfg.cell_size, cfg.cell_topk
    )
    dxm, dym = subpixel_offset_maps(s_raw)
    return xs, ys, resp, valid, dxm[ys, xs], dym[ys, xs], blurred


@functools.partial(jax.jit, static_argnames=("cfg", "with_pyramid"))
def extract_orb(img, cfg: OrbConfig, with_pyramid: bool = False):
    """Full-pyramid ORB extraction; one jit, all shapes static.

    The dense stages (FAST score + dual-threshold NMS + 7x7 blur) run per
    level, then every keypoint of every level goes through ONE batched
    per-keypoint stage: a single superpatch gather from the padded pyramid
    stacks followed by hat-weight contractions for the rotated-BRIEF bits
    and the oriented patch (no per-level gather chains).

    With with_pyramid=True additionally returns the (L, H, W) blurred
    pyramid stack (levels zero-padded to level-0 size) for KLT alignment.
    """
    pyr = build_pyramid(img, cfg)
    blur = [None] * cfg.n_levels
    H0, W0 = cfg.height, cfg.width
    xs_l, ys_l, fx_l, fy_l, resp_l, valid_l, lvl_l, uv_l = \
        [], [], [], [], [], [], [], []
    for l in range(cfg.n_levels):
        q = cfg.level_quotas[l]
        if q == 0:
            continue
        xs, ys, resp, valid, fx, fy, blur[l] = extract_level(pyr[l], q, cfg)
        # Pixel-center alignment: level pixel x maps to level-0 coordinate
        # (x + 0.5) * ratio - 0.5 with the *actual* per-axis resize ratio
        # (nominal 1.2^l drifts from the rounded level sizes).  Without this
        # every level carries a constant ~0.5*(ratio-1) px offset and level
        # hopping turns it into view-dependent measurement error.
        h_l, w_l = cfg.level_sizes[l]
        sx = W0 / w_l
        sy = H0 / h_l
        uv_l.append(jnp.stack([(xs + fx + 0.5) * sx - 0.5,
                               (ys + fy + 0.5) * sy - 0.5], axis=-1))
        xs_l.append(xs)
        ys_l.append(ys)
        fx_l.append(fx)
        fy_l.append(fy)
        resp_l.append(resp)
        valid_l.append(valid)
        lvl_l.append(jnp.full((q,), l, jnp.int32))
    xs = jnp.concatenate(xs_l)
    ys = jnp.concatenate(ys_l)
    fx = jnp.concatenate(fx_l)
    fy = jnp.concatenate(fy_l)
    lvl = jnp.concatenate(lvl_l)

    # Zero-quota levels still need their blur for the KLT pyramid stack.
    for l in range(cfg.n_levels):
        if blur[l] is None:
            blur[l] = gaussian_blur7(pyr[l])

    # Padded pyramid stacks: level images at offset (+R, +R) so a slice
    # starting at (y, x) is the 33x33 window centered on level pixel (y, x).
    R = SUPER_R

    def stack_padded(levels):
        out = []
        for l in range(cfg.n_levels):
            h, w = cfg.level_sizes[l]
            out.append(jnp.pad(levels[l],
                               ((R, H0 + R - h), (R, W0 + R - w))))
        return jnp.stack(out)

    raw_stack = stack_padded(pyr)
    blur_stack_p = stack_padded(blur)
    raw_sp = _gather_superpatches(raw_stack, lvl, ys, xs)
    blur_sp = _gather_superpatches(blur_stack_p, lvl, ys, xs)

    angle = _orientation_from_patches(raw_sp)
    desc = _descriptors_from_patches(blur_sp, fy, fx, angle)
    patch = _oriented_patches_from_patches(
        blur_sp, fy, fx, angle).astype(jnp.uint8)

    feats = OrbFeatures(
        uv=jnp.concatenate(uv_l),
        response=jnp.concatenate(resp_l),
        angle=angle,
        level=lvl,
        desc=desc,
        valid=jnp.concatenate(valid_l),
        patch=patch,
    )
    if with_pyramid:
        # Stack indexed by level number: levels skipped by a zero quota
        # still get a (blurred) slot so klt_refine can index by level.
        stack = []
        for l in range(cfg.n_levels):
            h, w = cfg.level_sizes[l]
            stack.append(jnp.pad(blur[l],
                                 ((0, H0 - h), (0, W0 - w))))
        return feats, jnp.stack(stack)
    return feats
