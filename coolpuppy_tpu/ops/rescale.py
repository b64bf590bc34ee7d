"""Rescaled (variable-size) snippet path — resampling as matmuls.

The reference's hardest kernel: variable (h, w) windows resized to a fixed
R×R with NaN propagation (reference coolpup.py:1193–1234 + cooltools
zoom_array). Under XLA's static shapes we gather every window padded to a
fixed Hmax and build per-snip *area-overlap interpolation matrices* from the
traced h and w:

    out = L(h) @ win @ R(w)^T,   L ∈ [R, Hmax],  L[i, k] = |out-cell i ∩ in-cell k| · R/h

Rows of L sum to 1, so this is an exact area-weighted average resize — two
small matmuls per snip, batched. (Deviation from the reference:
cooltools zoom_array uses an order-3 spline zoom + block-mean; area averaging
has the same mean-preserving semantics without spline ringing. Documented in
DESIGN.md.)

NaN handling follows the reference recipe: resize the NaN indicator plane with
the same operator and mark any output pixel it touches
(coolpup.py:1221–1228); empty/all-NaN snips become zeros (coolpup.py:1212–1213)
— which the accumulator then counts as finite, as upstream does.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial

import jax
import jax.numpy as jnp

from .gather import _gather_windows, _segment_add, _slice_vec


@dataclass(frozen=True)
class RescaleConfig:
    R: int  # output size (odd)
    Hmax: int  # padded gather window (>= max snip extent)
    B: int  # tile size == Hmax
    S: int
    block: int
    capacity: int
    cis: bool
    ignore_diags: int
    ooe: bool
    emit_expected: bool
    coverage: bool
    stripes: bool
    local: bool  # pre-resize symmetrization (reference coolpup.py:1215–1220)
    large_g: bool = False

    def __post_init__(self):
        assert self.Hmax <= self.B
        assert self.S % self.block == 0


def resize_matrix(h, R, Hmax, dtype=jnp.float32):
    """[R, Hmax] area-overlap operator for one traced input length h."""
    i = jax.lax.broadcasted_iota(jnp.int32, (R, Hmax), 0).astype(dtype)
    k = jax.lax.broadcasted_iota(jnp.int32, (R, Hmax), 1).astype(dtype)
    h = h.astype(dtype)
    cell = h / R  # input cells per output cell
    lo = i * cell
    hi = (i + 1.0) * cell
    overlap = jnp.maximum(
        0.0, jnp.minimum(hi, k + 1.0) - jnp.maximum(lo, k)
    )
    return overlap / jnp.maximum(cell, 1e-30)


def resize2d(win, h, w, R, Hmax):
    """Area-resize one [Hmax, Hmax] padded window with logical size (h, w).

    HIGHEST precision: full f32 products (FP32, not TF32, on a GPU). A
    reduced-precision default (bf16 or TF32 passes) costs ~1e-4..1e-3
    relative error against the host/CPU operator; full f32 keeps the
    deviation ~1e-6."""
    L = resize_matrix(h, R, Hmax)
    Rm = resize_matrix(w, R, Hmax)
    tmp = jnp.dot(
        L, win, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.dot(
        tmp, Rm.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def resize1d(vec, h, R, Hmax):
    L = resize_matrix(h, R, Hmax)
    return jnp.dot(
        L, vec[:, None], preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )[:, 0]


def area_resize_host(arr, out_shape):
    """Numpy twin of resize2d/resize1d for the host per-snip extension path
    (PileUpper.stream_snips under rescale): exact area-overlap average resize
    of a 1D or 2D array to ``out_shape`` (same semantics as the device
    operators above; replaces cooltools zoom_array, reference
    coolpup.py:1223–1233, with the documented area-average deviation)."""
    import numpy as np

    def op(n_in, n_out):
        i = np.arange(n_out)[:, None].astype(np.float64)
        k = np.arange(n_in)[None, :].astype(np.float64)
        cell = n_in / n_out
        overlap = np.maximum(
            0.0, np.minimum((i + 1) * cell, k + 1) - np.maximum(i * cell, k)
        )
        return overlap / max(cell, 1e-30)

    arr = np.asarray(arr, dtype=np.float64)
    if arr.ndim == 1:
        return op(arr.shape[0], out_shape[0]) @ arr
    left = op(arr.shape[0], out_shape[0])
    right = op(arr.shape[1], out_shape[1])
    return left @ arr @ right.T


@lru_cache(maxsize=32)
def make_rescale_step(cfg: RescaleConfig):
    """Jitted fused step for the rescale path (see make_rescale_step_fn)."""
    return jax.jit(make_rescale_step_fn(cfg))


@lru_cache(maxsize=32)
def make_rescale_step_fn(cfg: RescaleConfig):
    """Raw (unjitted) fused rescale step — jit directly for single-chip use
    or wrap in shard_map for multi-chip (parallel/mesh.py). Signature like
    make_pileup_step plus per-snip logical sizes h1, w2."""
    R, H, C = cfg.R, cfg.Hmax, cfg.capacity
    nblocks = cfg.S // cfg.block

    ii = jax.lax.broadcasted_iota(jnp.int32, (H, H), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (H, H), 1)
    dij = ii - jj

    def per_snip(win, v1, v2, h1, w2, dd0, evec):
        # width masks: the logical window is the [h1, w2] top-left corner
        wm1 = (ii[:, 0:1] < h1).astype(jnp.float32)  # [H,1]
        wm2 = (jj[0:1, :] < w2).astype(jnp.float32)  # [1,H]
        inside = wm1 * wm2
        mask = v1[:, None] * v2[None, :] * inside
        absd = jnp.abs(dd0 + dij)
        if cfg.cis and cfg.ignore_diags > 0:
            mask = mask * (absd >= cfg.ignore_diags)
        if cfg.ooe or cfg.emit_expected:
            eidx = jnp.clip(absd, 0, evec.shape[0] - 1)
            ew = evec[eidx]
        val = win / ew if cfg.ooe else win
        finite = jnp.isfinite(val)
        # data plane with explicit NaN where masked/not finite, as upstream
        dat = jnp.where((mask > 0) & finite, val, jnp.nan)
        dat = jnp.where(inside > 0, dat, 0.0)  # outside logical window: 0 pad

        if cfg.local:
            # nanmean(data, data.T) before resizing (coolpup.py:1215–1220)
            fin = jnp.isfinite(dat) & (inside > 0)
            finT = fin.T
            num = fin.astype(jnp.float32) + finT.astype(jnp.float32)
            s = jnp.where(fin, dat, 0.0) + jnp.where(finT, dat.T, 0.0)
            dat = jnp.where(num > 0, s / jnp.maximum(num, 1.0), jnp.nan)
            dat = jnp.where(inside > 0, dat, 0.0)

        nanplane = (~jnp.isfinite(dat)).astype(jnp.float32) * inside
        datz = jnp.where(jnp.isfinite(dat), dat, 0.0)

        rs = resize2d(datz, h1, w2, R, H)
        nanz = resize2d(nanplane, h1, w2, R, H)
        touched = nanz > 1e-6

        n_finite = jnp.sum(jnp.isfinite(dat) * inside)
        empty = n_finite == 0  # empty/all-NaN -> zeros (coolpup.py:1212)

        out_contrib = jnp.where(touched, 0.0, rs)
        out_num = jnp.where(touched, 0.0, 1.0)
        out_contrib = jnp.where(empty, 0.0, out_contrib)
        out_num = jnp.where(empty, 1.0, out_num)

        if cfg.emit_expected:
            # unmasked expected window, resized (coolpup.py:1130–1138, 1161–1162)
            ewz = jnp.where(jnp.isfinite(ew), ew, 0.0) * inside
            enan = (~jnp.isfinite(ew)).astype(jnp.float32) * inside
            ers = resize2d(ewz, h1, w2, R, H)
            enanz = resize2d(enan, h1, w2, R, H)
            etouched = enanz > 1e-6
            e_contrib = jnp.where(etouched, 0.0, ers)
            e_num = jnp.where(etouched, 0.0, 1.0)
        else:
            e_contrib = e_num = None

        return out_contrib, out_num, e_contrib, e_num

    def block_fn(carry, xs, tiles, tmap, ncolp, evec, valid1, valid2, cov1, cov2):
        r1, r2, h1, w2, dd0, cid, snipmask = xs

        class _G:  # adapter: reuse the shared tile gather at W=Hmax
            W = H
            B = cfg.B

        win = _gather_windows(tiles, tmap, ncolp, r1, r2, _G)
        v1 = _slice_vec(valid1, r1, H)
        v2 = _slice_vec(valid2, r2, H)

        contrib, num, e_contrib, e_num = jax.vmap(
            lambda w, a, b, hh, ww, d: per_snip(w, a, b, hh, ww, d, evec)
        )(win, v1, v2, h1, w2, dd0)

        smask = snipmask[:, None, None].astype(jnp.float32)
        contrib = contrib * smask
        num = num * smask

        if cfg.stripes:
            cntr = R // 2
            snip_nan = jnp.where(num > 0, contrib, jnp.nan)
            stripes_out = (snip_nan[:, cntr, :], snip_nan[:, ::-1, cntr])
        else:
            stripes_out = ()

        acc = dict(carry)
        acc["sum"] = _segment_add(acc["sum"], cid, contrib, cfg)
        acc["num"] = _segment_add(acc["num"], cid, num, cfg)

        if cfg.emit_expected:
            e_contrib = e_contrib * smask
            e_num = e_num * smask
            acc["exp_sum"] = _segment_add(acc["exp_sum"], cid, e_contrib, cfg)
            acc["exp_num"] = _segment_add(acc["exp_num"], cid, e_num, cfg)

        if cfg.coverage:
            c1 = _slice_vec(cov1, r1, H)
            c2 = _slice_vec(cov2, r2, H)
            c1 = jnp.where(jnp.isfinite(c1), c1, 0.0)
            c2 = jnp.where(jnp.isfinite(c2), c2, 0.0)
            c1r = jax.vmap(lambda v, hh: resize1d(v, hh, R, H))(c1, h1)
            c2r = jax.vmap(lambda v, ww: resize1d(v, ww, R, H))(c2, w2)
            c1r = c1r * snipmask[:, None]
            c2r = c2r * snipmask[:, None]
            acc["cov_start"] = _segment_add(acc["cov_start"], cid, c1r, cfg)
            acc["cov_end"] = _segment_add(acc["cov_end"], cid, c2r, cfg)

        return acc, stripes_out

    def step(tiles, tmap, ncolp, evec, valid1, valid2, cov1, cov2,
             r1, r2, h1, w2, dd0, cid, snipmask):
        zeros = lambda *shape: jnp.zeros(shape, jnp.float32)  # noqa: E731
        acc = {"sum": zeros(C, R, R), "num": zeros(C, R, R),
               "poison": zeros(C, R, R)}
        if cfg.emit_expected:
            acc["exp_sum"] = zeros(C, R, R)
            acc["exp_num"] = zeros(C, R, R)
        if cfg.coverage:
            acc["cov_start"] = zeros(C, R)
            acc["cov_end"] = zeros(C, R)

        def rb(x):
            return x.reshape(nblocks, cfg.block, *x.shape[1:])

        xs = tuple(rb(x) for x in (r1, r2, h1, w2, dd0, cid, snipmask))
        body = partial(
            block_fn, tiles=tiles, tmap=tmap, ncolp=ncolp, evec=evec,
            valid1=valid1, valid2=valid2, cov1=cov1, cov2=cov2,
        )
        acc, stripes = jax.lax.scan(lambda c, x: body(c, x), acc, xs)
        out = dict(acc)
        if cfg.stripes:
            h, v = stripes
            out["horizontal_stripe"] = h.reshape(cfg.S, R)
            out["vertical_stripe"] = v.reshape(cfg.S, R)
        return out

    return step
