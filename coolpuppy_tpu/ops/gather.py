"""Fused device pile-up step: batched window gather + normalize + flip +
grouped accumulation, in one jitted XLA program.

This is the device replacement of the reference's per-snip Python hot loop
(reference coolpup.py:1104–1191 — CSR slice, NaN bad rows/cols, LazyToeplitz
diag masking, OOE division, stripe extraction) and of its per-group nansum
accumulation (reference lib/puputils.py:12–41). NaN semantics become explicit
mask planes:

- ``valid`` = outer(good-bins) ∧ (|diag| ≥ ignore_diags)
- ``sum``   += where(valid ∧ finite(val), val, 0)       (the nansum)
- ``num``   += valid ∧ finite(val)                       (per-pixel n)
- ``poison``+= valid ∧ isinf(val)  — pixels where the reference's sum would
  have been +inf (ooe division by an expected of 0), turned into NaN at the
  end exactly like reference coolpup.py:1550–1552.

Snippet flipping (reference rot90∘flipud, coolpup.py:128–131) is linear, so it
is hoisted out of the hot loop entirely: callers route flipped snips to a
second bank of accumulator slots (cid + capacity/2) and anti-transpose that
bank once per group at the end (see merge_flip_banks).

Expected windows are an in-kernel toeplitz gather ``evec[|dd0 + i − j|]``
(replaces cooltools LazyToeplitz / ExpectedSnipper.select, reference
coolpup.py:907–917, 1100–1149); a length-1 ``evec`` gives the trans scalar
expected (coolpup.py:1126–1128). Snips are processed in fixed-size blocks via
``lax.scan`` so the device working set stays bounded; grouped reduction is a
one-hot matmul (or scatter-add for many groups, e.g. by-window pileups).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class GatherConfig:
    W: int  # window size (bins)
    B: int  # tile size, B >= W
    S: int  # snips per device call (padded)
    block: int  # snips per scan block
    capacity: int  # number of accumulation slots (kind x group, padded)
    cis: bool  # apply diagonal mask / toeplitz from dd0
    ignore_diags: int
    ooe: bool  # divide by expected in-kernel
    emit_expected: bool  # also accumulate expected windows (ooe=False mode)
    coverage: bool
    stripes: bool
    large_g: bool = False  # scatter-add instead of one-hot matmul

    def __post_init__(self):
        assert self.W <= self.B, "tile size must cover the window"
        assert self.S % self.block == 0


def _antitranspose(x):
    """rot90(flipud(x)) of the reference flip (coolpup.py:128–131):
    x[::-1, ::-1].T, batched over leading axis."""
    return jnp.flip(x, axis=(-2, -1)).swapaxes(-2, -1)


def _gather_windows(tiles, tmap, ncolp, r1, r2, cfg):
    """[b] window starts -> [b, W, W] dense windows via 2x2 tile assembly."""
    B, W = cfg.B, cfg.W
    t1, o1 = r1 // B, r1 % B
    t2, o2 = r2 // B, r2 % B
    k00 = tmap[t1 * ncolp + t2]
    k01 = tmap[t1 * ncolp + t2 + 1]
    k10 = tmap[(t1 + 1) * ncolp + t2]
    k11 = tmap[(t1 + 1) * ncolp + t2 + 1]
    top = jnp.concatenate([tiles[k00], tiles[k01]], axis=2)
    bot = jnp.concatenate([tiles[k10], tiles[k11]], axis=2)
    sup = jnp.concatenate([top, bot], axis=1)  # [b, 2B, 2B]
    return jax.vmap(
        lambda s, a, b: jax.lax.dynamic_slice(s, (a, b), (W, W))
    )(sup, o1, o2)


def _slice_vec(vec, starts, W):
    return jax.vmap(lambda s: jax.lax.dynamic_slice(vec, (s,), (W,)))(starts)


def _segment_add(acc, cid, planes, cfg):
    """acc[C, ...] += sum over snips grouped by cid."""
    if cfg.large_g:
        return acc.at[cid].add(planes)
    onehot = (
        cid[None, :] == jnp.arange(cfg.capacity, dtype=cid.dtype)[:, None]
    ).astype(jnp.float32)
    flat = planes.reshape(planes.shape[0], -1)
    # HIGHEST: full f32 products; a reduced-precision default (bf16 or
    # TF32 passes) would lose ~1e-3 relative against exact f32 adds
    return acc + jnp.dot(
        onehot,
        flat,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(acc.shape)


@lru_cache(maxsize=64)
def make_pileup_step(cfg: GatherConfig):
    """Jitted fused step for a static config (see make_pileup_step_fn)."""
    return jax.jit(make_pileup_step_fn(cfg))


@lru_cache(maxsize=64)
def make_pileup_step_fn(cfg: GatherConfig):
    """Build the raw (unjitted) fused step for a static config — jit it
    directly for single-chip use or wrap in shard_map for multi-chip
    (parallel/mesh.py). Returns
    step(tiles, tmap, ncolp, evec, valid1, valid2, cov1, cov2,
         r1, r2, dd0, cid, flip, snipmask) -> dict of accumulators."""

    W, C = cfg.W, cfg.capacity
    nblocks = cfg.S // cfg.block

    ii = jax.lax.broadcasted_iota(jnp.int32, (W, W), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (W, W), 1)
    dij = ii - jj  # [W, W]

    def block_fn(carry, xs, tiles, tmap, ncolp, evec, valid1, valid2, cov1, cov2):
        r1, r2, dd0, cid, snipmask = xs
        win = _gather_windows(tiles, tmap, ncolp, r1, r2, cfg)

        v1 = _slice_vec(valid1, r1, W)  # [b, W] 1.0 = usable bin
        v2 = _slice_vec(valid2, r2, W)
        mask = v1[:, :, None] * v2[:, None, :]

        dmat = dd0[:, None, None] + dij[None]  # global diagonal index
        absd = jnp.abs(dmat)
        if cfg.cis and cfg.ignore_diags > 0:
            mask = mask * (absd >= cfg.ignore_diags)

        if cfg.ooe or cfg.emit_expected:
            eidx = jnp.clip(absd, 0, evec.shape[0] - 1)
            ew = evec[eidx]  # [b, W, W]

        val = win / ew if cfg.ooe else win

        finite = jnp.isfinite(val)
        contrib = jnp.where(finite, val, 0.0) * mask
        numplane = finite.astype(jnp.float32) * mask
        poisplane = jnp.isinf(val).astype(jnp.float32) * mask

        smask = snipmask[:, None, None].astype(jnp.float32)
        contrib, numplane, poisplane = (
            contrib * smask,
            numplane * smask,
            poisplane * smask,
        )

        if cfg.stripes:
            cntr = W // 2
            snip_nan = jnp.where((mask > 0) & finite, val, jnp.nan)
            hstripe = snip_nan[:, cntr, :]
            vstripe = snip_nan[:, ::-1, cntr]
            # masked pixels are NaN in the reference's stripes too; stripes
            # are extracted pre-flip (coolpup.py:1164–1188), which the
            # flip-bank accumulation preserves automatically.
            stripes_out = (hstripe, vstripe)
        else:
            stripes_out = ()

        acc = dict(carry)
        acc["sum"] = _segment_add(acc["sum"], cid, contrib, cfg)
        acc["num"] = _segment_add(acc["num"], cid, numplane, cfg)
        acc["poison"] = _segment_add(acc["poison"], cid, poisplane, cfg)

        if cfg.emit_expected:
            # NOTE: the reference does NOT bad-bin/diag-mask the expected
            # channel (coolpup.py:1130–1138 leaves exp_data unmasked) — only
            # the snip padding mask applies here.
            efinite = jnp.isfinite(ew)
            econtrib = jnp.where(efinite, ew, 0.0) * smask
            enumplane = efinite.astype(jnp.float32) * smask
            acc["exp_sum"] = _segment_add(acc["exp_sum"], cid, econtrib, cfg)
            acc["exp_num"] = _segment_add(acc["exp_num"], cid, enumplane, cfg)

        if cfg.coverage:
            c1 = _slice_vec(cov1, r1, W) * snipmask[:, None]
            c2 = _slice_vec(cov2, r2, W) * snipmask[:, None]
            c1 = jnp.where(jnp.isfinite(c1), c1, 0.0)
            c2 = jnp.where(jnp.isfinite(c2), c2, 0.0)
            acc["cov_start"] = _segment_add(acc["cov_start"], cid, c1, cfg)
            acc["cov_end"] = _segment_add(acc["cov_end"], cid, c2, cfg)

        return acc, stripes_out

    def step(tiles, tmap, ncolp, evec, valid1, valid2, cov1, cov2,
             r1, r2, dd0, cid, snipmask):
        zeros = lambda *shape: jnp.zeros(shape, jnp.float32)  # noqa: E731
        acc = {
            "sum": zeros(C, W, W),
            "num": zeros(C, W, W),
            "poison": zeros(C, W, W),
        }
        if cfg.emit_expected:
            acc["exp_sum"] = zeros(C, W, W)
            acc["exp_num"] = zeros(C, W, W)
        if cfg.coverage:
            acc["cov_start"] = zeros(C, W)
            acc["cov_end"] = zeros(C, W)

        def reshape_blocks(x):
            return x.reshape(nblocks, cfg.block, *x.shape[1:])

        xs = tuple(
            reshape_blocks(x) for x in (r1, r2, dd0, cid, snipmask)
        )
        body = partial(
            block_fn,
            tiles=tiles,
            tmap=tmap,
            ncolp=ncolp,
            evec=evec,
            valid1=valid1,
            valid2=valid2,
            cov1=cov1,
            cov2=cov2,
        )
        acc, stripes = jax.lax.scan(lambda c, x: body(c, x), acc, xs)
        out = dict(acc)
        if cfg.stripes:
            h, v = stripes
            out["horizontal_stripe"] = h.reshape(cfg.S, W)
            out["vertical_stripe"] = v.reshape(cfg.S, W)
        return out

    return step


def merge_flip_banks(out, half):
    """Collapse the flip bank: slots [half:2*half] hold snips accumulated
    unflipped that *should* be flipped; anti-transpose those sums once and add
    them to slots [0:half]. Linearity of the flip makes this exactly equal to
    flipping every snip individually (reference coolpup.py:128–131).
    Coverage vectors are NOT flipped, matching the reference (flip_snip_func
    swaps no cov_ keys)."""
    merged = {}
    for k, v in out.items():
        if k in ("horizontal_stripe", "vertical_stripe"):
            merged[k] = v
            continue
        lo, hi = v[:half], v[half : 2 * half]
        if v.ndim == 3:  # [C, W, W] planes get anti-transposed
            hi = np.flip(hi, axis=(-2, -1)).swapaxes(-2, -1)
        merged[k] = lo + hi
    return merged


def _next_pow2(x):
    return 1 << max(0, int(np.ceil(np.log2(max(1, x)))))


def pad_pow2(arr, axis=0, fill=0):
    """Pad an array's axis to the next power of two (shape-stable jit)."""
    n = arr.shape[axis]
    target = _next_pow2(n)
    if target == n:
        return arr
    pads = [(0, 0)] * arr.ndim
    pads[axis] = (0, target - n)
    return np.pad(arr, pads, constant_values=fill)
