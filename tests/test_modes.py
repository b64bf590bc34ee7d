"""Mode coverage: shifted controls (numeric vs oracle), local, coverage_norm,
bedpe, trans, by_window, flip_negative_strand."""

import numpy as np
import pandas as pd
import pytest

from coolpuppy_tpu import CoordCreator, PileUpper, pileup

from fixtures import make_toy_cooler, toy_features, toy_regions
from oracle import oracle_snip, oracle_accumulate


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = tmp_path_factory.mktemp("cool") / "toy.cool"
    return make_toy_cooler(str(path), seed=5)


def oracle_region_accumulate(clr, weights, cc, regions, control, coverage=None):
    """Oracle over CC.batches snips for both kinds; returns dict kind->acc."""
    out = {"ROI": [], "control": []}
    for _, reg in regions.iterrows():
        rt = (reg["chrom"], reg["start"], reg["end"])
        lo, hi = clr.extent(rt)
        off = clr.offset(reg["chrom"])
        min_left = lo - off
        n = hi - lo
        csr = clr.fetch_coo(rt, balance="weight" if weights is not None else False).tocsr()
        isnan = (
            np.isnan(weights[lo:hi])
            if weights is not None
            else np.zeros(n, bool)
        )
        cov = coverage[lo:hi] if coverage is not None else None
        for frame in cc.batches(rt, None, control=control):
            for _, row in frame.iterrows():
                r1 = int(row["stBin1"]) - min_left
                r2 = int(row["stBin2"]) - min_left
                W = int(row["endBin1"] - row["stBin1"])
                if r1 < 0 or r2 < 0 or r1 + W > n or r2 + W > n:
                    continue
                data, _ = oracle_snip(
                    csr,
                    r1,
                    r2,
                    W,
                    W,
                    isnan,
                    isnan,
                    dd0=int(row["stBin1"] - row["stBin2"]),
                    ignore_diags=2,
                    cis=True,
                )
                cs = cov[r1 : r1 + W] if cov is not None else np.zeros(W)
                ce = cov[r2 : r2 + W] if cov is not None else np.zeros(W)
                out[row["kind"]].append((data, cs, ce))
    return {k: oracle_accumulate(v) for k, v in out.items() if v}


def test_controls_vs_oracle(toy):
    clr, dense, weights = toy
    regions = toy_regions()
    cc = CoordCreator(
        toy_features(),
        1_000_000,
        features_format="bed",
        flank=2_000_000,
        mindist=0,
        nshifts=3,
        seed=11,
    )
    pu = PileUpper(clr, cc, expected=False, view_df=regions, control=True)
    pup = pu.pileupsWithControl()
    got = pup.loc[pup["group"] == "all", "data"].iloc[0]
    accs = oracle_region_accumulate(clr, weights, cc, regions, control=True)
    roi = accs["ROI"]
    ctrl = accs["control"]
    want = (roi["data"] / roi["num"]) / (ctrl["data"] / ctrl["num"])
    want = np.where(np.isinf(want), np.nan, want)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-8, equal_nan=True)
    assert int(pup.loc[pup["group"] == "all", "control_n"].iloc[0]) == ctrl["n"]


def test_coverage_norm_vs_oracle(toy):
    clr, dense, weights = toy
    regions = toy_regions()
    cc = CoordCreator(
        toy_features(),
        1_000_000,
        features_format="bed",
        flank=2_000_000,
        mindist=0,
        nshifts=0,
    )
    pu = PileUpper(
        clr,
        cc,
        expected=False,
        ooe=False,
        view_df=regions,
        clr_weight_name=None,
        coverage_norm=True,
    )
    pup = pu.pileupsWithControl()
    got = pup.loc[pup["group"] == "all", "data"].iloc[0]

    from coolpuppy_tpu.coverage import coverage as compute_cov

    _, cov_tot = compute_cov(clr, ignore_diags=2)
    accs = oracle_region_accumulate(
        clr, None, cc, regions, control=False, coverage=cov_tot
    )
    roi = accs["ROI"]
    # reference: norm_coverage on accumulated pup, then /num
    # (coolpup.py:1533–1541, lib/puputils.py:168–190)
    covmat = np.outer(roi["cov_start"], roi["cov_end"])
    covmat = covmat / np.nanmean(covmat)
    data = roi["data"] / covmat
    data[np.isnan(data)] = 0
    want = data / roi["num"]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-8, equal_nan=True)


def test_local_pileup(toy):
    clr, dense, weights = toy
    cc = CoordCreator(
        toy_features(),
        1_000_000,
        features_format="bed",
        flank=2_000_000,
        local=True,
        nshifts=0,
        mindist=0,
    )
    pu = PileUpper(clr, cc, expected=False, ooe=False, view_df=toy_regions())
    pup = pu.pileupsWithControl()
    got = pup.loc[pup["group"] == "all", "data"].iloc[0]
    assert pup["n"].iloc[0] == 6
    # symmetric output
    np.testing.assert_allclose(got, got.T, equal_nan=True)


def test_bedpe_pileup(toy):
    clr, dense, weights = toy
    feats = pd.DataFrame(
        {
            "chrom1": ["chr1", "chr1", "chr2"],
            "start1": [102_000_000, 102_000_000, 102_000_000],
            "end1": [102_500_000, 102_500_000, 102_500_000],
            "chrom2": ["chr1", "chr1", "chr2"],
            "start2": [105_000_000, 108_000_000, 108_000_000],
            "end2": [105_500_000, 108_500_000, 108_500_000],
        }
    )
    pup = pileup(
        clr=clr,
        features=feats,
        features_format="bedpe",
        view_df=toy_regions(),
        mindist=0,
        flank=2_000_000,
    )
    assert pup["n"].iloc[0] == 3

    # same accumulation through the bed path over matching anchor pairs
    cc = CoordCreator(
        feats, 1_000_000, features_format="bedpe", flank=2_000_000, mindist=0
    )
    pu = PileUpper(clr, cc, expected=False, ooe=False, view_df=toy_regions())
    pup2 = pu.pileupsWithControl()
    np.testing.assert_allclose(
        pup.loc[pup["group"] == "all", "data"].iloc[0],
        pup2.loc[pup2["group"] == "all", "data"].iloc[0],
        equal_nan=True,
    )


def test_trans_pileup(toy):
    clr, dense, weights = toy
    pup = pileup(
        clr=clr,
        features=toy_features(),
        features_format="bed",
        view_df=toy_regions(),
        trans=True,
        flank=2_000_000,
    )
    # 3 features per chrom -> 3x3 cross products between foo and bar
    assert pup["n"].iloc[0] == 9
    got = pup.loc[pup["group"] == "all", "data"].iloc[0]

    # oracle: trans windows, no diag mask
    snips = []
    lo1, hi1 = clr.extent(("chr1", 100_000_000, 150_000_000))
    lo2, hi2 = clr.extent(("chr2", 100_000_000, 150_000_000))
    csr = clr.fetch_coo(
        ("chr1", 100_000_000, 150_000_000),
        ("chr2", 100_000_000, 150_000_000),
        balance="weight",
    ).tocsr()
    isnan1 = np.isnan(weights[lo1:hi1])
    isnan2 = np.isnan(weights[lo2:hi2])
    for c1 in (102, 105, 108):
        for c2 in (102, 105, 108):
            r1, r2 = c1 - 2 - 100, c2 - 2 - 100
            data, _ = oracle_snip(
                csr, r1, r2, 5, 5, isnan1, isnan2, dd0=0, cis=False
            )
            snips.append((data, np.zeros(5), np.zeros(5)))
    acc = oracle_accumulate(snips)
    want = acc["data"] / acc["num"]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-8, equal_nan=True)


def test_by_window(toy):
    clr, dense, weights = toy
    pup = pileup(
        clr=clr,
        features=toy_features(),
        features_format="bed",
        view_df=toy_regions(),
        mindist=0,
        flank=2_000_000,
        by_window=True,
    )
    # one row per feature + "all"
    assert pup.shape[0] == 7
    allrow = pup[pup["chrom"] == "all"]
    assert int(allrow["n"].iloc[0]) == 12  # each pair contributes to 2 windows
    per_window = pup[pup["chrom"] != "all"]
    assert set(per_window["n"]) == {2}


def test_flip_negative_strand(toy):
    clr, dense, weights = toy
    pup = pileup(
        clr=clr,
        features=toy_features(),
        features_format="bed",
        view_df=toy_regions(),
        mindist=0,
        flank=2_000_000,
        flip_negative_strand=True,
    )
    assert pup["n"].iloc[0] == 6


def test_column_hint_matches_full_frames(toy):
    """The coordgen column hint (engine fast path) must be output-invariant:
    a no-op USER modify func disables the hint (full frames), and every
    output must match the hinted run exactly — guards the hint set against
    future columns the device path starts reading."""
    clr, dense, weights = toy

    def run(disable_hint):
        kw = {}
        if disable_hint:
            kw["modify_2Dintervals_func"] = lambda f: f
        cc = CoordCreator(
            toy_features(), 1_000_000, features_format="bed",
            flank=3_000_000, mindist=0, nshifts=2, seed=0,
        )
        pu = PileUpper(
            clr, cc, view_df=toy_regions(), control=True, expected=False,
            store_stripes=True, flip_negative_strand=True,
        )
        return pu.pileupsWithControl(**kw)

    a = run(False).set_index("group").loc["all"]
    b = run(True).set_index("group").loc["all"]
    assert a["n"] == b["n"] and a["control_n"] == b["control_n"]
    np.testing.assert_allclose(
        a["data"], b["data"], rtol=1e-6, atol=1e-12, equal_nan=True
    )
    np.testing.assert_allclose(
        np.asarray(a["horizontal_stripe"], float),
        np.asarray(b["horizontal_stripe"], float),
        rtol=1e-6, atol=1e-12, equal_nan=True,
    )
    assert (
        np.asarray(a["coordinates"], dtype=object)
        == np.asarray(b["coordinates"], dtype=object)
    ).all()


def test_trans_expected_ooe(toy):
    """pileup(trans=True, expected_df=...) — trans OOE divides every pixel
    by the region pair's scalar expected (reference coolpup.py:999–1005,
    1130–1139)."""
    from coolpuppy_tpu.expected import expected_trans

    clr, dense, weights = toy
    exp = expected_trans(clr)
    # align expected region names with the view (chr1 -> foo, chr2 -> bar)
    name_of = {"chr1": "foo", "chr2": "bar"}
    exp = exp.assign(
        region1=exp["region1"].map(name_of),
        region2=exp["region2"].map(name_of),
    )
    raw = pileup(
        clr=clr,
        features=toy_features(),
        features_format="bed",
        view_df=toy_regions(),
        trans=True,
        flank=2_000_000,
    )
    ooe = pileup(
        clr=clr,
        features=toy_features(),
        features_format="bed",
        view_df=toy_regions(),
        trans=True,
        flank=2_000_000,
        expected_df=exp,
    )
    n_raw = int(raw.loc[raw["group"] == "all", "n"].iloc[0])
    n_ooe = int(ooe.loc[ooe["group"] == "all", "n"].iloc[0])
    assert n_raw == n_ooe == 9
    # only one region pair (foo x bar): ooe == raw / scalar expected
    sub = exp[(exp["region1"] == "foo") & (exp["region2"] == "bar")]
    scalar = float(sub["balanced.avg"].iloc[0])
    got = ooe.loc[ooe["group"] == "all", "data"].iloc[0]
    want = raw.loc[raw["group"] == "all", "data"].iloc[0] / scalar
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8,
                               equal_nan=True)


def test_by_window_flip_negative_strand(toy):
    """dual-anchor by-window must honor flip_negative_strand (round-4
    regression: the fast path zeroed the flip column) — outputs must match
    the frame-duplication path exactly."""
    clr, dense, weights = toy
    feats = toy_features()

    def build():
        cc = CoordCreator(
            feats, 1_000_000, features_format="bed", flank=2_000_000,
            mindist=0, nshifts=0,
        )
        return PileUpper(
            clr, cc, view_df=toy_regions(), expected=False,
            flip_negative_strand=True,
        )

    via_dual = build().pileupsByWindowWithControl()
    from coolpuppy_tpu.lib.puputils import group_by_region_frame

    ref = build().pileupsWithControl(
        postprocess_frame_func=group_by_region_frame
    )
    ref_map = {
        tuple(g): d
        for g, d in zip(ref["group"], ref["data"])
        if g != "all"
    }
    body = via_dual[via_dual["chrom"] != "all"]
    assert len(body) == len(ref_map) > 0
    for _, row in body.iterrows():
        key = (row["chrom"], row["start"], row["end"])
        np.testing.assert_allclose(
            row["data"], ref_map[key], rtol=1e-6, atol=1e-12,
            equal_nan=True, err_msg=str(key),
        )
    # flipping must actually change something for stranded features
    cc2 = CoordCreator(
        feats, 1_000_000, features_format="bed", flank=2_000_000,
        mindist=0, nshifts=0,
    )
    noflip = PileUpper(
        clr, cc2, view_df=toy_regions(), expected=False
    ).pileupsByWindowWithControl()
    b1 = via_dual[via_dual["chrom"] != "all"]
    b2 = noflip[noflip["chrom"] != "all"]
    diffs = [
        np.nanmax(np.abs(np.asarray(x) - np.asarray(y)))
        for x, y in zip(b1["data"], b2["data"])
    ]
    assert max(diffs) > 0


def test_bedpe_by_distance_and_by_window(toy):
    """bedpe + by_distance (round-4 regression: the column hint dropped
    the stored 'distance' column) and bedpe + by_window (frame fallback)."""
    clr, dense, weights = toy
    feats = pd.DataFrame(
        {
            "chrom1": ["chr1", "chr1", "chr1"],
            "start1": [102_000_000, 102_000_000, 105_000_000],
            "end1": [102_500_000, 102_500_000, 105_500_000],
            "chrom2": ["chr1", "chr1", "chr1"],
            "start2": [105_000_000, 108_000_000, 110_000_000],
            "end2": [105_500_000, 108_500_000, 110_500_000],
        }
    )
    cc = CoordCreator(
        feats, 1_000_000, features_format="bedpe", flank=2_000_000,
        mindist=0, nshifts=0,
    )
    pu = PileUpper(clr, cc, view_df=toy_regions(), expected=False)
    by_dist = pu.pileupsByDistanceWithControl(
        distance_edges=[0, 4_000_000, 1_000_000_000]
    )
    body = by_dist[by_dist["separation"] != "all"]
    assert body["n"].sum() == 3

    cc2 = CoordCreator(
        feats, 1_000_000, features_format="bedpe", flank=2_000_000,
        mindist=0, nshifts=0,
    )
    pu2 = PileUpper(clr, cc2, view_df=toy_regions(), expected=False)
    by_win = pu2.pileupsByWindowWithControl()
    wins = by_win[by_win["chrom"] != "all"]
    # anchors {102, 105, 108, 110} Mb -> 4 unique windows, 6 snip slots
    assert len(wins) == 4
    assert wins["n"].sum() == 6


def test_by_window_rescale(toy):
    """by_window + rescale (round-4 regression: UnboundLocalError on W and
    a fixed-window assert in the dual-anchor path)."""
    clr, dense, weights = toy
    feats = toy_features()
    cc = CoordCreator(
        feats, 1_000_000, features_format="bed", rescale_flank=1,
        mindist=0, nshifts=0,
    )
    pu = PileUpper(
        clr, cc, view_df=toy_regions(), expected=False, rescale=True,
        rescale_size=33,
    )
    pups = pu.pileupsByWindowWithControl()
    body = pups[pups["chrom"] != "all"]
    assert len(body) > 0
    assert body["data"].iloc[0].shape == (33, 33)


def test_by_window_duplicate_intervals(toy):
    """Duplicate BED intervals must merge into ONE window group (the
    reference's group_by_region keys on coordinates; round-4's per-row
    anchor ids split them)."""
    clr, dense, weights = toy
    feats = toy_features()
    dup = pd.concat([feats, feats.iloc[[0]]], ignore_index=True)
    cc = CoordCreator(
        dup, 1_000_000, features_format="bed", flank=2_000_000,
        mindist=0, nshifts=0,
    )
    pu = PileUpper(clr, cc, view_df=toy_regions(), expected=False)
    pups = pu.pileupsByWindowWithControl()
    body = pups[pups["chrom"] != "all"]
    keys = list(zip(body["chrom"], body["start"], body["end"]))
    assert len(keys) == len(set(keys)), "duplicate window rows"
    # the duplicated anchor's window accumulates BOTH copies' snips
    base_cc = CoordCreator(
        feats, 1_000_000, features_format="bed", flank=2_000_000,
        mindist=0, nshifts=0,
    )
    base_pu = PileUpper(clr, base_cc, view_df=toy_regions(), expected=False)
    base = base_pu.pileupsByWindowWithControl()
    base_body = base[base["chrom"] != "all"]
    k0 = (feats["chrom"].iloc[0],)
    dup_row = body[body["start"] == body["start"].min()].iloc[0]
    base_row = base_body[
        base_body["start"] == base_body["start"].min()
    ].iloc[0]
    assert dup_row["n"] > base_row["n"]
