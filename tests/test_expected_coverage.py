"""expected.py and coverage.py against brute-force dense computations."""

import numpy as np
import pytest

from coolpuppy_tpu.coverage import coverage
from coolpuppy_tpu.expected import expected_cis, expected_trans

from fixtures import make_toy_cooler, toy_regions


def test_expected_cis_matches_fixture_oracle(tmp_path):
    clr, dense, weights = make_toy_cooler(str(tmp_path / "t.cool"), seed=9)
    regions = toy_regions()
    exp = expected_cis(clr, view_df=regions, ignore_diags=0)
    # brute force for region foo
    lo, hi = clr.extent(("chr1", 100_000_000, 150_000_000))
    block = dense[("chr1", "chr1")][
        lo : hi, lo : hi
    ].astype(float)
    w = weights[lo:hi]
    bal = block * np.outer(np.nan_to_num(w), np.nan_to_num(w))
    valid = ~np.isnan(w)
    n = hi - lo
    sub = exp[exp["region1"] == "foo"].set_index("dist")
    for d in (0, 1, 5, 20, n - 1):
        i = np.arange(n - d)
        nv = int((valid[i] & valid[i + d]).sum())
        assert sub.loc[d, "n_valid"] == nv
        np.testing.assert_allclose(
            sub.loc[d, "balanced.sum"], bal[i, i + d].sum(), rtol=1e-9
        )
        if nv:
            np.testing.assert_allclose(
                sub.loc[d, "balanced.avg"], bal[i, i + d].sum() / nv, rtol=1e-9
            )


def test_expected_trans(tmp_path):
    clr, dense, weights = make_toy_cooler(str(tmp_path / "t.cool"), seed=9)
    exp = expected_trans(clr)
    block = dense[("chr1", "chr2")].astype(float)
    w1 = weights[: block.shape[0]]
    w2 = weights[block.shape[0] :]
    bal = block * np.outer(np.nan_to_num(w1), np.nan_to_num(w2))
    nv = int((~np.isnan(w1)).sum()) * int((~np.isnan(w2)).sum())
    row = exp.iloc[0]
    np.testing.assert_allclose(row["balanced.sum"], bal.sum(), rtol=1e-9)
    np.testing.assert_allclose(row["balanced.avg"], bal.sum() / nv, rtol=1e-9)


def test_coverage_matches_dense(tmp_path):
    clr, dense, weights = make_toy_cooler(str(tmp_path / "t.cool"), seed=9)
    cis, tot = coverage(clr, ignore_diags=2)
    n1 = dense[("chr1", "chr1")].shape[0]
    b11 = dense[("chr1", "chr1")].copy()
    for d in range(2):
        i = np.arange(n1 - d)
        b11[i, i + d] = 0
        b11[i + d, i] = 0
    want_cis_chr1 = b11.sum(axis=1)
    np.testing.assert_allclose(cis[:n1], want_cis_chr1)
    want_tot_chr1 = want_cis_chr1 + dense[("chr1", "chr2")].sum(axis=1)
    np.testing.assert_allclose(tot[:n1], want_tot_chr1)


@pytest.mark.parametrize("large_g", [False, True])
def test_step_coverage_matches_slices(large_g):
    """cov_start / cov_end of the fused step == per-group sums of each
    snip's coverage slices, nonfinite entries counted as 0 (reference
    per-snip coverage slices, coolpup.py:1152-1153), for both group
    reductions (one-hot matmul and scatter-add)."""
    from scipy import sparse

    from coolpuppy_tpu.ops.gather import (
        GatherConfig,
        make_pileup_step,
        pad_pow2,
    )
    from coolpuppy_tpu.ops.tiles import build_tile_stack

    rng = np.random.default_rng(3)
    W, G, S, n, B = 11, 6, 512, 256, 64
    r1 = rng.integers(0, n - W, S).astype(np.int32)
    r2 = rng.integers(0, n - W, S).astype(np.int32)
    cid = rng.integers(0, G, S).astype(np.int32)
    cov1 = rng.random(n + B).astype(np.float32)
    cov2 = rng.random(n + B).astype(np.float32)
    cov1[rng.integers(0, n, 10)] = np.nan
    cov2[rng.integers(0, n, 10)] = np.inf
    mat = sparse.coo_matrix(
        (np.ones(50), (rng.integers(0, n, 50), rng.integers(0, n, 50))),
        shape=(n, n),
    )
    ts = build_tile_stack(mat, B, r1=r1, r2=r2, window1=W, window2=W)
    cfg = GatherConfig(
        W=W, B=B, S=S, block=128, capacity=8, cis=True, ignore_diags=2,
        ooe=False, emit_expected=False, coverage=True, stripes=False,
        large_g=large_g,
    )
    valid = np.ones(n + B, np.float32)
    out = make_pileup_step(cfg)(
        ts.tiles, pad_pow2(ts.tile_map.ravel()),
        np.int32(ts.tile_map.shape[1]), np.ones(1, np.float32), valid,
        valid, cov1, cov2, r1, r2, r1 - r2, cid, np.ones(S, bool),
    )
    for key, cov, starts in (("cov_start", cov1, r1), ("cov_end", cov2, r2)):
        clean = np.where(np.isfinite(cov), cov, 0.0).astype(np.float64)
        want = np.zeros((8, W))
        for s, g in zip(starts, cid):
            want[g] += clean[s : s + W]
        np.testing.assert_allclose(
            np.asarray(out[key]), want, rtol=1e-5, atol=1e-5, err_msg=key
        )
