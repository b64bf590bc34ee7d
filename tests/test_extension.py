"""Extension mechanism end-to-end: per-snip data hooks + extra accumulators
(the reference's advertised hook system, reference coolpup.py:1261–1283,
lib/puputils.py:39–41, 244–253; usage pattern of the TAD-score notebook,
SURVEY §3.3)."""

from functools import partial

import numpy as np
import pandas as pd
import pytest

from coolpuppy_tpu import CoordCreator, PileUpper
from coolpuppy_tpu.lib.numutils import get_domain_score
from coolpuppy_tpu.lib.puputils import accumulate_values

from fixtures import make_toy_cooler, toy_features, toy_regions

BINSIZE = 1_000_000


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = tmp_path_factory.mktemp("cool") / "toy_ext.cool"
    return make_toy_cooler(str(path), seed=11)


def tad_features():
    # TAD-like intervals of varying extents on chr1
    starts = np.array([101, 109, 118, 126, 133]) * BINSIZE
    ends = starts + np.array([5, 6, 4, 5, 7]) * BINSIZE
    return pd.DataFrame({"chrom": "chr1", "start": starts, "end": ends})


def test_domain_score_pattern(toy):
    """Reference §3.3: local rescaled pileup with a per-snip domain score
    accumulated into an output column."""
    clr, dense, weights = toy
    cc = CoordCreator(
        tad_features(),
        BINSIZE,
        features_format="bed",
        local=True,
        rescale_flank=1,
        nshifts=0,
        mindist=0,
    )
    pu = PileUpper(
        clr, cc, expected=False, control=False, rescale=True, rescale_size=33
    )

    def add_domain_score(snip):
        snip["domain_score"] = get_domain_score(snip["data"], 1)
        return snip

    pups = pu.pileupsWithControl(
        postprocess_snip_func=add_domain_score,
        extra_sum_funcs={
            "domain_score": partial(accumulate_values, key="domain_score")
        },
    )
    row = pups.set_index("group").loc["all"]
    scores = row["domain_score"]
    assert isinstance(scores, list)
    assert len(scores) == row["n"] == len(tad_features())
    assert all(np.isfinite(s) for s in scores)
    # data plane produced by the host path must be a real pileup
    assert row["data"].shape == (33, 33)
    assert np.isfinite(row["data"]).any()


def test_hostpath_matches_device_path(toy):
    """A no-op per-snip hook must reproduce the device-path pileup exactly
    (same normalized tiles feed both)."""
    clr, dense, weights = toy
    feats = pd.DataFrame(
        {
            "chrom": ["chr1"] * 4,
            "start": np.array([102, 105, 108, 112]) * BINSIZE,
            "end": np.array([102, 105, 108, 112]) * BINSIZE + 500_000,
            "strand": ["+", "-", "+", "-"],
        }
    )

    def build(hook):
        cc = CoordCreator(
            feats, BINSIZE, features_format="bed", flank=3 * BINSIZE, nshifts=0
        )
        pu = PileUpper(clr, cc, expected=False, control=False)
        return pu.pileupsWithControl(postprocess_snip_func=hook)

    via_host = build(lambda snip: snip)
    cc = CoordCreator(
        feats, BINSIZE, features_format="bed", flank=3 * BINSIZE, nshifts=0
    )
    pu = PileUpper(clr, cc, expected=False, control=False)
    via_device = pu.pileupsWithControl()

    a = via_host.set_index("group").loc["all"]
    b = via_device.set_index("group").loc["all"]
    assert a["n"] == b["n"] > 0
    np.testing.assert_allclose(a["data"], b["data"], rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(a["num"], b["num"])


def test_snip_hook_multiplies_groups(toy):
    """A generator hook yielding several group copies per snip (the
    group_by_region pattern) multiplies counts accordingly."""
    clr, dense, weights = toy
    feats = pd.DataFrame(
        {
            "chrom": ["chr1"] * 3,
            "start": np.array([102, 106, 110]) * BINSIZE,
            "end": np.array([102, 106, 110]) * BINSIZE + 500_000,
        }
    )
    cc = CoordCreator(
        feats, BINSIZE, features_format="bed", flank=2 * BINSIZE, nshifts=0
    )
    pu = PileUpper(clr, cc, expected=False, control=False)

    def duplicate(snip):
        left = dict(snip)
        left["group"] = "left"
        right = dict(snip)
        right["group"] = "right"
        yield left
        yield right

    pups = pu.pileupsWithControl(postprocess_snip_func=duplicate)
    by_group = pups.set_index("group")
    assert by_group.loc["left", "n"] == by_group.loc["right", "n"] > 0
    assert by_group.loc["all", "n"] == (
        by_group.loc["left", "n"] + by_group.loc["right", "n"]
    )


def test_accumulate_values_frame_column_device_path(toy):
    """accumulate_values over a FRAME column must stay on the device kernel
    (no host snip stream) and reproduce the host path's lists exactly
    (reference puputils.py:244–253)."""
    clr, dense, weights = toy
    rng = np.random.default_rng(5)
    feats = pd.DataFrame(
        {
            "chrom": ["chr1"] * 6,
            "start": np.array([102, 104, 107, 110, 113, 117]) * BINSIZE,
            "end": np.array([102, 104, 107, 110, 113, 117]) * BINSIZE
            + 500_000,
            "strand": ["+", "-", "+", "-", "+", "-"],
            "score": rng.uniform(0, 10, 6).round(3),
        }
    )
    funcs = {"score1": partial(accumulate_values, key="score1")}

    def build(force_host):
        cc = CoordCreator(
            feats, BINSIZE, features_format="bed", flank=3 * BINSIZE,
            nshifts=0, mindist=0,
        )
        pu = PileUpper(clr, cc, expected=False, control=False)
        kw = dict(extra_sum_funcs=funcs, groupby=["strand1", "strand2"])
        if force_host:
            kw["postprocess_snip_func"] = lambda snip: snip
        return pu.pileupsWithControl(**kw)

    via_device = build(False)
    via_host = build(True)
    a = via_device.set_index(via_device["group"].astype(str))
    b = via_host.set_index(via_host["group"].astype(str))
    assert set(a.index) == set(b.index)
    for g in a.index:
        assert a.loc[g, "n"] == b.loc[g, "n"]
        np.testing.assert_allclose(
            np.asarray(a.loc[g, "score1"], dtype=float),
            np.asarray(b.loc[g, "score1"], dtype=float),
            err_msg=str(g),
        )
        np.testing.assert_allclose(
            a.loc[g, "data"], b.loc[g, "data"],
            rtol=1e-5, atol=1e-8, equal_nan=True, err_msg=str(g),
        )


def test_opaque_extra_sum_func_falls_back_to_host(toy):
    """A non-accumulate_values extra func (opaque callable) must still work
    via the host stream."""
    clr, dense, weights = toy
    feats = pd.DataFrame(
        {
            "chrom": ["chr1"] * 3,
            "start": np.array([103, 108, 114]) * BINSIZE,
            "end": np.array([103, 108, 114]) * BINSIZE + 500_000,
        }
    )

    def count_snips(pup, snip):
        pup["snipcount"] = pup.get("snipcount", 0) + 1
        return pup

    cc = CoordCreator(
        feats, BINSIZE, features_format="bed", flank=2 * BINSIZE, nshifts=0
    )
    pu = PileUpper(clr, cc, expected=False, control=False)
    pups = pu.pileupsWithControl(extra_sum_funcs={"snipcount": count_snips})
    row = pups.set_index("group").loc["all"]
    assert row["snipcount"] == row["n"] > 0


def test_batch_hook_matches_snip_hook(toy):
    """postprocess_batch_func (vectorized per-snip-data hook) must produce
    the same pileup and the same extras as the per-snip dict hook."""
    from functools import partial

    import numpy as np

    from coolpuppy_tpu import CoordCreator, PileUpper
    from coolpuppy_tpu.lib.puputils import accumulate_values

    clr, dense, weights = toy
    mid = 3  # 7x7 windows with flank 3*binsize

    def snip_post(snip):
        snip["center"] = float(
            np.nansum(snip["data"][mid - 1 : mid + 2, mid - 1 : mid + 2])
        )
        yield snip

    def batch_post(frame, data):
        frame = frame.copy(deep=False)
        frame["center"] = np.nansum(
            np.nan_to_num(
                data[:, mid - 1 : mid + 2, mid - 1 : mid + 2], posinf=np.inf
            ),
            axis=(1, 2),
        )
        return frame

    def run(hook_kw):
        cc = CoordCreator(
            toy_features(), BINSIZE, features_format="bed",
            flank=3 * BINSIZE, nshifts=0, mindist=0, seed=0,
        )
        pu = PileUpper(
            clr, cc, view_df=toy_regions(), expected=False, control=False
        )
        return pu.pileupsWithControl(
            extra_sum_funcs={
                "center": partial(accumulate_values, key="center")
            },
            **hook_kw,
        )

    a = run(dict(postprocess_snip_func=snip_post)).set_index("group").loc["all"]
    b = run(dict(postprocess_batch_func=batch_post)).set_index("group").loc["all"]
    assert a["n"] == b["n"] > 0
    np.testing.assert_allclose(
        np.nan_to_num(np.asarray(a["data"], float), posinf=1e30),
        np.nan_to_num(np.asarray(b["data"], float), posinf=1e30),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_array_equal(a["num"], b["num"])
    ca = np.sort(np.asarray(a["center"], float))
    cb = np.sort(np.asarray(b["center"], float))
    np.testing.assert_allclose(ca, cb, rtol=1e-5, atol=1e-6)
