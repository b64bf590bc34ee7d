"""Engine-level parity of the device route (the fused XLA step) against
the host snip stream (stream_snips: per-snip windows cut on the host from
the normalized tile stack, the route per-snip hooks take) in the modes
with their own device code: coverage_norm, expected emission (ooe=False),
stripes, by-window group counts, trans, bedpe and user-moved
coordinates."""

import numpy as np
import pandas as pd
import pytest

from coolpuppy_tpu import CoordCreator, PileUpper
from coolpuppy_tpu.lib.puputils import group_by_region_frame

from fixtures import make_toy_cooler, toy_expected, toy_features, toy_regions

BINSIZE = 1_000_000


def _identity(snip):
    return snip


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = tmp_path_factory.mktemp("cool") / "toy_pm.cool"
    return make_toy_cooler(str(path), seed=13)


def _both(make_pu, **kw):
    """(device, host) pile-ups of the same PileUpper settings; an identity
    postprocess_snip_func sends every region through the host stream."""
    dev = make_pu().pileupsWithControl(**kw)
    host = make_pu().pileupsWithControl(postprocess_snip_func=_identity, **kw)
    return dev, host


def _pu(clr, nshifts=0, **kw):
    def make():
        cc = CoordCreator(
            toy_features(), BINSIZE, features_format="bed",
            flank=3 * BINSIZE, nshifts=nshifts, mindist=0, seed=0,
        )
        return PileUpper(clr, cc, view_df=toy_regions(), **kw)

    return make


def _compare(pups_a, pups_b, stripes=False):
    a = pups_a.set_index("group").loc["all"]
    b = pups_b.set_index("group").loc["all"]
    assert a["n"] == b["n"] > 0
    np.testing.assert_array_equal(
        np.isnan(np.asarray(a["data"], float)),
        np.isnan(np.asarray(b["data"], float)),
    )
    np.testing.assert_allclose(
        np.nan_to_num(a["data"], posinf=1e30),
        np.nan_to_num(b["data"], posinf=1e30),
        rtol=1e-4,
        atol=1e-7,
    )
    np.testing.assert_array_equal(a["num"], b["num"])
    if stripes:
        for key in ("horizontal_stripe", "vertical_stripe"):
            np.testing.assert_allclose(
                np.nan_to_num(np.asarray(a[key], float)),
                np.nan_to_num(np.asarray(b[key], float)),
                rtol=1e-4,
                atol=1e-7,
                err_msg=key,
            )


def test_device_coverage_norm(toy):
    clr, dense, weights = toy
    _compare(*_both(_pu(clr, expected=False, coverage_norm=True,
                        clr_weight_name=None)))


def test_device_expected_emission(toy):
    """expected without ooe: the expected channel is accumulated beside
    the data (the control rows)."""
    clr, dense, weights = toy
    exp = toy_expected(clr, dense, toy_regions(), weights=weights)
    dev, host = _both(_pu(clr, expected=exp, ooe=False))
    _compare(dev, host)
    a = dev.set_index("group").loc["all"]
    b = host.set_index("group").loc["all"]
    np.testing.assert_array_equal(a["control_num"], b["control_num"])


def test_device_stripes(toy):
    clr, dense, weights = toy
    _compare(*_both(_pu(clr, nshifts=1, control=True, expected=False,
                        store_stripes=True)), stripes=True)


def test_device_by_window_groups(toy):
    """One group per anchor: the device's dual-anchor path against the
    frame-duplicating by-region grouping on the host stream."""
    clr, dense, weights = toy
    make = _pu(clr, expected=False)
    dev = make().pileupsByWindowWithControl()
    host = make().pileupsWithControl(
        postprocess_frame_func=group_by_region_frame,
        postprocess_snip_func=_identity,
    )
    host = host[host["group"] != "all"]
    want = {
        (g[0], int(g[1]), int(g[2])): row
        for g, (_, row) in zip(host["group"], host.iterrows())
    }
    body = dev[dev["chrom"] != "all"]
    assert len(body) == len(want) > 2
    for _, row in body.iterrows():
        other = want[(row["chrom"], int(row["start"]), int(row["end"]))]
        assert row["n"] == other["n"]
        np.testing.assert_allclose(
            np.nan_to_num(np.asarray(row["data"], float)),
            np.nan_to_num(np.asarray(other["data"], float)),
            rtol=1e-4,
            atol=1e-7,
        )


def test_device_trans(toy):
    """Trans pileups (rectangular regions, scalar expected frames)."""
    clr, dense, weights = toy

    def make():
        cc = CoordCreator(
            toy_features(), BINSIZE, features_format="bed",
            flank=3 * BINSIZE, trans=True, nshifts=1, seed=0,
        )
        return PileUpper(clr, cc, view_df=toy_regions(), expected=False,
                         control=True)

    _compare(*_both(make))


def test_device_bedpe(toy):
    """Explicit bedpe pairs with shifted controls."""
    clr, dense, weights = toy
    feats = pd.DataFrame(
        {
            "chrom1": ["chr1", "chr1", "chr1"],
            "start1": [102_000_000, 104_000_000, 108_000_000],
            "end1": [102_500_000, 104_500_000, 108_500_000],
            "chrom2": ["chr1", "chr1", "chr1"],
            "start2": [105_000_000, 109_000_000, 112_000_000],
            "end2": [105_500_000, 109_500_000, 112_500_000],
        }
    )

    def make():
        cc = CoordCreator(
            feats, BINSIZE, features_format="bedpe",
            flank=2 * BINSIZE, mindist=0, nshifts=2, seed=0,
        )
        return PileUpper(clr, cc, view_df=toy_regions(), expected=False,
                         control=True)

    _compare(*_both(make))


def test_device_moved_coordinates(tmp_path):
    """A modify func that moves window coordinates far off the diagonal:
    the tile stack follows the moved windows. Needs a region spanning many
    tiles so a shift can leave the diagonal band."""
    binsize = 100_000
    clr, dense, weights = make_toy_cooler(
        str(tmp_path / "abort.cool"),
        chromsizes={"chrZ": 300_000_000},
        binsize=binsize,
        seed=17,
    )
    rng = np.random.default_rng(3)
    starts = np.sort(
        rng.choice(np.arange(20, 2900), 30, replace=False)
    ) * binsize
    feats = pd.DataFrame(
        {"chrom": "chrZ", "start": starts, "end": starts + binsize}
    )

    def shift_away(frame):
        frame = frame.copy()
        sel = np.arange(len(frame)) % 2 == 1
        for c in ("stBin2", "endBin2"):
            frame.loc[sel, c] = frame.loc[sel, c] - 400
        for c in ("start2", "end2", "center2"):
            frame.loc[sel, c] = frame.loc[sel, c] - 400 * binsize
        return frame[frame["stBin2"] >= 0].reset_index(drop=True)

    def make():
        cc = CoordCreator(
            feats, binsize, features_format="bed",
            flank=3 * binsize, mindist=0, maxdist=50 * binsize, seed=0,
        )
        return PileUpper(clr, cc, expected=False)

    _compare(*_both(make, modify_2Dintervals_func=shift_away))


def test_device_stripes_with_controls(toy):
    """store_stripes + shifted controls: stripe planes/coordinates exist
    only for ROI snips (control planes never reach the output, reference
    coolpup.py:1533–1625) on both routes, and the output stripes row count
    equals the ROI n."""
    clr, dense, weights = toy
    dev, host = _both(_pu(clr, nshifts=2, expected=False, control=True,
                          store_stripes=True))
    a = dev.set_index("group").loc["all"]
    b = host.set_index("group").loc["all"]
    assert a["n"] == b["n"] > 0
    ha = np.asarray(a["horizontal_stripe"], float)
    hb = np.asarray(b["horizontal_stripe"], float)
    assert ha.shape == hb.shape == (a["n"], ha.shape[1])
    np.testing.assert_allclose(
        np.nan_to_num(ha), np.nan_to_num(hb), rtol=1e-4, atol=1e-7
    )
    ca = np.asarray(a["coordinates"], dtype=object)
    cb = np.asarray(b["coordinates"], dtype=object)
    assert ca.shape == cb.shape == (a["n"], 6)
    assert (ca == cb).all()


def test_tile_f16_wire_engine_parity(toy):
    """Engine-level f16 tile wire (the rescale upload): force the mode past
    the CPU gate (which keeps CPU goldens exact; accelerators run it by
    default) and check the rescaled pile-up at f16 tolerance."""
    clr, dense, weights = toy
    feats = toy_features()
    feats = feats.assign(end=feats["start"] + 4 * BINSIZE)

    def rescaled(wire):
        cc = CoordCreator(feats, BINSIZE, features_format="bed", local=True,
                          rescale_flank=1.0, nshifts=0, mindist=0)
        pu = PileUpper(clr, cc, view_df=toy_regions(), rescale=True,
                       rescale_size=33, expected=False)
        pu._tile_f16_mode = lambda: wire  # balanced toy cooler values
        return pu.pileupsWithControl()

    want = rescaled(False)
    got = rescaled("lossy")
    a = want.set_index("group").loc["all"]
    b = got.set_index("group").loc["all"]
    assert a["n"] == b["n"] > 0
    np.testing.assert_array_equal(a["num"], b["num"])
    fin = np.isfinite(np.asarray(a["data"], float))
    np.testing.assert_allclose(
        np.asarray(b["data"], float)[fin],
        np.asarray(a["data"], float)[fin],
        rtol=2e-3, atol=1e-5,
    )
