"""Batched KLT-style patch alignment for match verification/refinement.

The reference associates observations purely by binary-descriptor distance
inside pose-predicted windows (ORBmatcher.cc SearchByProjection family).
On self-similar texture this admits coherent mis-registrations that "fit"
the pose (NOTES.md: pose-gated match-selection feedback).  This module adds
what the reference lacks: after descriptor NN, each match is verified and
sub-pixel-refined by direct photometric alignment of the frame's local
intensity window against the landmark's stored canonical patch (forward-
additive Lucas-Kanade, translation + gain/bias invariance via zero-mean
gain-fitted residuals).

Everything is fixed-shape and batched over matches: N keypoints x (2r+1)^2
window samples x fixed GN iterations — pure elementwise work under one jit.

Conventions match ops/orb.py gather_oriented_patches: the canonical patch
grid (gy, gx) maps to image coords p = c + R(a) @ (gx, gy) with
R(a) = [[ca, -sa], [sa, ca]]; templates are sampled from the 7x7-Gaussian-
blurred level image, so alignment runs on the blurred pyramid too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam3_study_kr_tpu.ops.orb import PATCH_R

# Super-patch half-extent: rotated patch reach (r * sqrt2) + max shift +
# bilinear/gradient margin.
_SPAN = 13
_S = 2 * _SPAN + 1


def _hat(d):
    """Bilinear interpolation kernel max(0, 1 - |d|)."""
    return jnp.maximum(0.0, 1.0 - jnp.abs(d))


@functools.partial(jax.jit, static_argnames=("iters",))
def klt_refine(pyr_stack, level_wh, uv_l0, level, angle, tmpl, mask,
               iters: int = 5, max_shift: float = 3.0):
    """Align each keypoint's oriented window to its template.

    Args:
      pyr_stack: (L, H, W) float32 blurred pyramid, level l valid in
        [:h_l, :w_l], zero elsewhere.
      level_wh: (L, 2) float32 [w_l, h_l] per level.
      uv_l0: (N, 2) float32 keypoint centers, level-0 raw pixel coords.
      level: (N,) int32 keypoint pyramid level.
      angle: (N,) float32 keypoint canonical orientation (radians).
      tmpl: (N, P, P) float32/uint8 canonical template patches (P=2*PATCH_R+1).
      mask: (N,) bool — refine only these (others pass through unchanged).
      iters: GN iterations (static).
      max_shift: max allowed translation in level pixels.

    Returns:
      uv_ref: (N, 2) refined level-0 coords (= uv_l0 where not accepted).
      zncc: (N,) final zero-mean NCC between aligned window and template.
      shift: (N,) |d| in level pixels (max_shift+1 where masked out).
      win: (N, P, P) float32 aligned intensity window (the patch resampled
        at the refined position — use it to refresh the frame's stored
        patch so patch center and keypoint coordinate stay consistent).
    """
    L, H, W = pyr_stack.shape
    w_l = level_wh[:, 0]
    h_l = level_wh[:, 1]
    lvl = jnp.clip(level, 0, L - 1)
    # Per-keypoint level -> level-0 scale from the true (rounded) level sizes.
    sx = level_wh[0, 0] / w_l[lvl]
    sy = level_wh[0, 1] / h_l[lvl]
    # level coords of the keypoint (inverse of the pixel-center mapping).
    x_l = (uv_l0[:, 0] + 0.5) / sx - 0.5
    y_l = (uv_l0[:, 1] + 0.5) / sy - 0.5

    xi = jnp.round(x_l).astype(jnp.int32)
    yi = jnp.round(y_l).astype(jnp.int32)
    fx = x_l - xi.astype(jnp.float32)
    fy = y_l - yi.astype(jnp.float32)

    def gather_sp(l, yc, xc):
        return jax.lax.dynamic_slice(
            pyr_stack, (l, yc - _SPAN, xc - _SPAN), (1, _S, _S))[0]

    sp = jax.vmap(gather_sp)(lvl, yi, xi)  # (N, S, S)

    grid = jnp.arange(-PATCH_R, PATCH_R + 1, dtype=jnp.float32)
    gy, gx = jnp.meshgrid(grid, grid, indexing="ij")
    gx = gx.ravel()[None]  # (1, P*P)
    gy = gy.ravel()[None]

    ca = jnp.cos(angle)[:, None]
    sa = jnp.sin(angle)[:, None]
    cx = (_SPAN + fx)[:, None]
    cy = (_SPAN + fy)[:, None]

    t = tmpl.astype(jnp.float32).reshape(tmpl.shape[0], -1)
    t0 = t - t.mean(axis=1, keepdims=True)
    t0_ss = jnp.maximum((t0 * t0).sum(axis=1), 1e-6)

    # Bilinear sampling as separable hat-weight contractions instead of
    # per-element gathers: sample(sp, px, py) = A @ sp @ B with
    # A[p, s] = hat(py[p] - s), B[p, t] = hat(px[p] - t) — two batched
    # (P*P, S) x (S, S) matmuls per evaluation, in place of per-element gathers.
    # The central-difference gradients become shifted-hat weight
    # matrices, numerically identical to resampling at px +- 1.
    s_iota = jnp.arange(_S, dtype=jnp.float32)

    def window_and_grads(dx, dy):
        ux = gx + dx[:, None]
        uy = gy + dy[:, None]
        px = cx + ux * ca - uy * sa   # (N, P*P)
        py = cy + ux * sa + uy * ca
        dyy = py[..., None] - s_iota  # (N, P*P, S)
        dxx = px[..., None] - s_iota
        A = _hat(dyy)
        B = _hat(dxx)
        dA = 0.5 * (_hat(dyy + 1.0) - _hat(dyy - 1.0))
        dB = 0.5 * (_hat(dxx + 1.0) - _hat(dxx - 1.0))
        C = jnp.einsum("nps,nst->npt", A, sp)    # y-interpolated rows
        w = jnp.einsum("npt,npt->np", C, B)
        ix = jnp.einsum("npt,npt->np", C, dB)
        C2 = jnp.einsum("nps,nst->npt", dA, sp)
        iy = jnp.einsum("npt,npt->np", C2, B)
        return w, ix, iy

    dx = jnp.zeros(uv_l0.shape[0], jnp.float32)
    dy = jnp.zeros(uv_l0.shape[0], jnp.float32)
    for _ in range(iters):
        w, ix, iy = window_and_grads(dx, dy)
        w0 = w - w.mean(axis=1, keepdims=True)
        g = (w0 * t0).sum(axis=1) / t0_ss
        r = w0 - g[:, None] * t0
        jx = ix * ca + iy * sa       # dW/d(dx)
        jy = -ix * sa + iy * ca      # dW/d(dy)
        h11 = (jx * jx).sum(axis=1) + 1e-3
        h12 = (jx * jy).sum(axis=1)
        h22 = (jy * jy).sum(axis=1) + 1e-3
        b1 = (jx * r).sum(axis=1)
        b2 = (jy * r).sum(axis=1)
        det = jnp.maximum(h11 * h22 - h12 * h12, 1e-6)
        ddx = (h22 * b1 - h12 * b2) / det
        ddy = (h11 * b2 - h12 * b1) / det
        dx = jnp.clip(dx - ddx, -max_shift, max_shift)
        dy = jnp.clip(dy - ddy, -max_shift, max_shift)

    def zncc_at(ddx, ddy):
        w, _, _ = window_and_grads(dx + ddx, dy + ddy)
        w0 = w - w.mean(axis=1, keepdims=True)
        w_ss = jnp.maximum((w0 * w0).sum(axis=1), 1e-6)
        return (w0 * t0).sum(axis=1) / jnp.sqrt(w_ss * t0_ss), w

    zncc, w = zncc_at(0.0, 0.0)
    P = tmpl.shape[1]
    win = w.reshape(-1, P, P)

    # Alias-ambiguity probe: on self-similar texture the aligned optimum is
    # one of several near-identical basins, and moving the observation to
    # it "perfects" a wrong registration (NOTES.md: klt_move_obs
    # regression).  Score the template at 4 probe offsets one texture-cell
    # away from the optimum; the margin zncc - max(probe zncc) measures how
    # DISTINCTIVE the aligned position is.  Periodic texture -> margin ~ 0.
    probe = 2.5
    amb = jnp.full(zncc.shape, -1.0, zncc.dtype)
    for pdx, pdy in ((probe, 0.0), (-probe, 0.0), (0.0, probe),
                     (0.0, -probe)):
        z_p, _ = zncc_at(pdx, pdy)
        amb = jnp.maximum(amb, z_p)
    distinct = zncc - amb

    # Refined center in level coords, then back to level-0.
    rx = x_l + dx * ca[:, 0] - dy * sa[:, 0]
    ry = y_l + dx * sa[:, 0] + dy * ca[:, 0]
    u0 = (rx + 0.5) * sx - 0.5
    v0 = (ry + 0.5) * sy - 0.5
    uv_ref = jnp.where(mask[:, None], jnp.stack([u0, v0], axis=-1), uv_l0)
    shift = jnp.where(mask, jnp.sqrt(dx * dx + dy * dy), max_shift + 1.0)
    zncc = jnp.where(mask, zncc, -1.0)
    distinct = jnp.where(mask, distinct, -1.0)
    return uv_ref, zncc, shift, win, distinct


def stack_pyramid(pyr_levels):
    """Pad a list of per-level blurred images into one (L, H, W) stack."""
    H, W = pyr_levels[0].shape
    out = []
    for img in pyr_levels:
        h, w = img.shape
        out.append(jnp.pad(img, ((0, H - h), (0, W - w))))
    return jnp.stack(out)


def make_level_wh(cfg) -> np.ndarray:
    """(L, 2) float32 [w_l, h_l] table for an OrbConfig."""
    return np.asarray(
        [[cfg.level_sizes[l][1], cfg.level_sizes[l][0]]
         for l in range(cfg.n_levels)], np.float32)
