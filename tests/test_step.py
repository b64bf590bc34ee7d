"""The fused XLA step (ops/gather.py) against a dense oracle of the
reference hot loop (coolpup.py:1104-1191), the host normalization it
shares with the snip stream, and the tile-wire helpers."""

import numpy as np
import pytest
from scipy import sparse as sp

from coolpuppy_tpu.ops.gather import GatherConfig, make_pileup_step, pad_pow2
from coolpuppy_tpu.ops.tiles import (
    assemble_window,
    build_tile_stack,
    normalize_tile_stack,
)


def _matrix(rng, n, density):
    dense = rng.gamma(1.0, 1.0, (n, n)) * (rng.random((n, n)) < density)
    dense = np.triu(dense) + np.triu(dense, 1).T
    return dense, sp.coo_matrix(dense)


def _oracle_matrix(dense, valid, evec, ooe, ignore_diags=2):
    """The normalized matrix of the reference hot loop: bad bins and the
    first diagonals NaN, divided by the toeplitz expected under ooe."""
    n = dense.shape[0]
    mat = np.asarray(dense, np.float64).copy()
    bad = np.asarray(valid)[:n] == 0
    mat[bad, :] = np.nan
    mat[:, bad] = np.nan
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    d = np.abs(ii - jj)
    mat[d < ignore_diags] = np.nan
    if ooe:
        ev = np.full((n, n), np.nan)
        ok = d < len(evec)
        ev[ok] = np.asarray(evec, np.float64)[d[ok]]
        with np.errstate(divide="ignore", invalid="ignore"):
            mat = mat / ev
    return mat


def _oracle_sums(mat, r1, r2, cid, W, C):
    """Per-group nansum, finite count and +inf (poison) count."""
    s = np.zeros((C, W, W))
    m = np.zeros((C, W, W))
    p = np.zeros((C, W, W))
    for a, b, g in zip(r1, r2, cid):
        win = mat[a : a + W, b : b + W]
        fin = np.isfinite(win)
        s[g] += np.where(fin, win, 0.0)
        m[g] += fin
        p[g] += np.isinf(win)
    return s, m, p


def _step(ts, r1, r2, cid, valid, evec, W, C, S, ooe=True, stripes=False,
          large_g=False, n_real=None):
    cfg = GatherConfig(
        W=W, B=ts.B, S=S, block=min(128, S), capacity=C, cis=True,
        ignore_diags=2, ooe=ooe, emit_expected=False, coverage=False,
        stripes=stripes, large_g=large_g,
    )

    def padded(a):
        out = np.zeros(S, np.int32)
        out[: len(a)] = a
        return out

    mask = np.zeros(S, bool)
    mask[: len(r1) if n_real is None else n_real] = True
    out = make_pileup_step(cfg)(
        ts.tiles, pad_pow2(ts.tile_map.ravel()),
        np.int32(ts.tile_map.shape[1]), evec, valid, valid,
        np.zeros(8, np.float32), np.zeros(8, np.float32),
        padded(r1), padded(r2), padded((r1 - r2).astype(np.int32)),
        padded(cid), mask,
    )
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


@pytest.mark.parametrize("ooe", [False, True])
def test_step_matches_oracle(ooe):
    """sum, num and poison of the fused step equal the dense oracle,
    with expected zeros that poison some pixels (+inf in the reference's
    sums, coolpup.py:1154-1156)."""
    rng = np.random.default_rng(0)
    n, W, B, S, C = 300, 11, 64, 256, 8
    dense, coo = _matrix(rng, n, 0.3)
    r1 = rng.integers(0, n - W, S).astype(np.int32)
    r2 = rng.integers(0, n - W, S).astype(np.int32)
    cid = rng.integers(0, 6, S).astype(np.int32)
    valid = np.zeros(512, np.float32)
    valid[:n] = (rng.random(n) > 0.1).astype(np.float32)
    evec = np.full(512, np.nan, np.float32)
    evec[:n] = (10.0 / (1.0 + np.arange(n))).astype(np.float32)
    evec[rng.integers(2, n, 5)] = 0.0  # exercise poison

    ts = build_tile_stack(coo, B, r1=r1, r2=r2, window1=W, window2=W)
    got = _step(ts, r1, r2, cid, valid, evec, W, C, S, ooe=ooe)
    want_s, want_m, want_p = _oracle_sums(
        _oracle_matrix(dense, valid, evec[:n], ooe), r1, r2, cid, W, C
    )
    assert (want_p.sum() > 0) == ooe
    np.testing.assert_array_equal(got["poison"], want_p)
    np.testing.assert_array_equal(got["num"], want_m)
    np.testing.assert_allclose(got["sum"], want_s, rtol=1e-5, atol=1e-5)


def test_step_many_groups_heavy_quad():
    """Many groups (600: the scatter-add reduction) and one tile quad far
    busier than the rest, against the oracle; padding snips add nothing."""
    rng = np.random.default_rng(7)
    n, W, B, C, S = 700, 11, 64, 600, 1500
    dense, coo = _matrix(rng, n, 0.2)
    valid = (rng.random(n) > 0.05).astype(np.float32)
    evec = (5.0 / (1.0 + np.arange(n))).astype(np.float32)
    r1 = np.concatenate([
        3 + rng.integers(0, 5, 900), rng.integers(0, n - W, S - 900),
    ]).astype(np.int32)
    r2 = np.concatenate([
        9 + rng.integers(0, 5, 900), rng.integers(0, n - W, S - 900),
    ]).astype(np.int32)
    cid = rng.integers(0, C, S).astype(np.int32)
    cid[:10] = C - 1

    ts = build_tile_stack(coo, B, r1=r1, r2=r2, window1=W, window2=W)
    got = _step(ts, r1, r2, cid, valid, evec, W, C, 2048, large_g=True)
    want_s, want_m, _ = _oracle_sums(
        _oracle_matrix(dense, valid, evec, True), r1, r2, cid, W, C
    )
    assert not got["poison"].any()
    np.testing.assert_array_equal(got["num"], want_m)
    np.testing.assert_allclose(got["sum"], want_s, rtol=1e-4, atol=1e-4)

    # an all-padding call returns zeroed accumulators
    empty = _step(ts, r1, r2, cid, valid, evec, W, C, 2048, large_g=True,
                  n_real=0)
    assert empty["sum"].shape == (C, W, W)
    assert empty["sum"].sum() == 0.0 and empty["num"].sum() == 0.0


def test_step_stripes_match_oracle():
    """Per-snip horizontal and (reversed) vertical stripes of the step vs
    the dense oracle (reference coolpup.py:1164-1188)."""
    rng = np.random.default_rng(3)
    n, W, B, S = 500, 11, 64, 1024
    dense, coo = _matrix(rng, n, 0.25)
    valid = (rng.random(n) > 0.08).astype(np.float32)
    evec = (4.0 / (1.0 + np.arange(n))).astype(np.float32)
    r1 = rng.integers(0, n - W, 900).astype(np.int32)
    r2 = rng.integers(0, n - W, 900).astype(np.int32)
    cid = np.zeros(900, np.int32)

    ts = build_tile_stack(coo, B, r1=r1, r2=r2, window1=W, window2=W)
    got = _step(ts, r1, r2, cid, valid, evec, W, 8, S, stripes=True)
    mat = _oracle_matrix(dense, valid, evec, True)
    mid = W // 2
    for k in rng.integers(0, 900, 40):
        a, b = int(r1[k]), int(r2[k])
        for key, want in (
            ("horizontal_stripe", mat[a + mid, b : b + W]),
            ("vertical_stripe", mat[a : a + W, b + mid][::-1]),
        ):
            np.testing.assert_allclose(
                got[key][k], want, rtol=1e-5, atol=1e-5, equal_nan=True,
            )


def test_host_normalize_matches_oracle_and_clips_padded_valid():
    """normalize_tile_stack (the snip stream's NaN-encoded stack) cut into
    windows equals the oracle matrix, also when the valid and expected
    vectors are pow2-padded past the tiled extent (as the engine passes
    them)."""
    rng = np.random.default_rng(1)
    n, W, B = 300, 11, 64
    dense, coo = _matrix(rng, n, 0.3)
    r1 = rng.integers(0, n - W, 64).astype(np.int32)
    r2 = rng.integers(0, n - W, 64).astype(np.int32)
    ts = build_tile_stack(coo, B, r1=r1, r2=r2, window1=W, window2=W)
    valid = (rng.random(n) > 0.1).astype(np.float32)
    evec = (10.0 / (1.0 + np.arange(n))).astype(np.float32)
    vpad = np.zeros(16384, np.float32)
    vpad[:n] = valid
    epad = np.full(16384, np.nan, np.float32)
    epad[:n] = evec

    stiles = normalize_tile_stack(
        ts, vpad, vpad, evec=epad, ooe=True, cis=True, ignore_diags=2
    )
    mat = _oracle_matrix(dense, valid, evec, True)
    for a, b in zip(r1, r2):
        got = assemble_window(stiles, ts.tile_map, B, int(a), int(b), W, W)
        np.testing.assert_allclose(
            got, mat[a : a + W, b : b + W], rtol=1e-6, atol=1e-6,
            equal_nan=True,
        )


def test_cast_tiles_f16_exact_and_lossy():
    """Wire-compression safety gates (ops/tiles.cast_tiles_f16):
    integer counts round-trip bit-exactly under the pow2 scale; lossy
    mode bounds the relative error at 2^-11; inexact payloads are
    REFUSED in exact mode (ship f32)."""
    from coolpuppy_tpu.ops.tiles import cast_tiles_f16

    rng = np.random.default_rng(3)
    # raw integer counts <= 2048: always exact
    counts = rng.poisson(5.0, (7, 32, 32)).astype(np.float32)
    wire, inv = cast_tiles_f16(counts, "exact")
    np.testing.assert_array_equal(
        wire.astype(np.float32) * inv, counts
    )
    # counts that need > 11 significand bits: exact mode must refuse
    big = counts.copy()
    big[0, 0, 0] = 30011.0  # odd, > 2^14 -> not f16-representable
    assert cast_tiles_f16(big, "exact") is None
    # ... but lossy mode ships them at bounded relative error
    wire, inv = cast_tiles_f16(big, "lossy")
    rt = wire.astype(np.float32) * inv
    err = np.abs(rt - big) / np.maximum(np.abs(big), 1e-30)
    assert float(err.max()) <= 2.0 ** -11 + 1e-7
    # balanced-like floats, tiny magnitudes: the pow2 scale keeps them in
    # f16's normal range (no subnormal precision collapse)
    small = (rng.gamma(1.0, 1.0, (5, 16, 16)) * 1e-6).astype(np.float32)
    wire, inv = cast_tiles_f16(small, "lossy")
    rt = wire.astype(np.float32) * inv
    nz = small > 0
    err = np.abs(rt[nz] - small[nz]) / small[nz]
    assert float(err.max()) <= 2.0 ** -11 + 1e-7
    # NaN pixels (NaN balancing weights fold into raw tiles) survive
    nanny = counts.copy()
    nanny[1, 2, 3] = np.nan
    wire, inv = cast_tiles_f16(nanny, "exact")
    rt = wire.astype(np.float32) * inv
    assert np.isnan(rt[1, 2, 3])
    np.testing.assert_array_equal(rt, nanny)
    # off switch
    assert cast_tiles_f16(counts, False) is None


def test_expand_sym_f16_wire():
    """tile_f16 wire compression through the upper-triangle expansion the
    rescale path uploads: "exact" on integer counts is bit-identical to
    the f32 wire; "lossy" on float values stays within the f16 bound."""
    from coolpuppy_tpu.io.cool import PixelSlab
    from coolpuppy_tpu.ops.tiles import (
        build_tile_stack_slab_sym,
        expand_sym_device,
    )

    rng = np.random.default_rng(17)
    n, B = 900, 128
    i = rng.integers(0, n, 40_000)
    j = np.minimum(i + rng.integers(0, 300, 40_000), n - 1)
    for vals, mode, rtol in (
        (rng.poisson(2.0, len(i)).astype(np.float32) + 1, "exact", 0),
        (rng.gamma(1.0, 1.0, len(i)).astype(np.float32), "lossy", 2.0**-11),
    ):
        slab = PixelSlab(rows=i, cols=j, vals=vals, lo1=0, lo2=0,
                         shape=(n, n), mirror=True, weights=None)
        sym = build_tile_stack_slab_sym(slab, B)
        want = np.asarray(expand_sym_device(sym))
        got = np.asarray(expand_sym_device(sym, f16_mode=mode))
        if mode == "exact":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
