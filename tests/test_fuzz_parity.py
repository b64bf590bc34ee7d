"""Seeded fuzz parity: randomized flag combinations + randomized features
through BOTH engine routes (the fused device step vs the host snip
stream, which cuts every window on the host) must agree on every output
row. Complements the hand-picked combo matrix with configuration
diversity; seeds are fixed so failures reproduce."""

import numpy as np
import pandas as pd
import pytest

from coolpuppy_tpu import PileUpper, pileup
from coolpuppy_tpu.expected import expected_cis

from fixtures import make_toy_cooler, toy_regions

N_CASES = 8


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = tmp_path_factory.mktemp("cool") / "fuzz.cool"
    return make_toy_cooler(str(path), seed=202)


@pytest.fixture(scope="module")
def exp(toy):
    clr, dense, weights = toy
    return expected_cis(clr, view_df=toy_regions())


def random_case(rng, exp):
    n = int(rng.integers(6, 30))
    chroms = rng.choice(["chr1", "chr2"], n)
    starts = (
        rng.integers(101, 148, n).astype(np.int64) * 1_000_000
        + rng.integers(0, 2, n) * 500_000
    )
    feats = pd.DataFrame(
        {
            "chrom": chroms,
            "start": starts,
            "end": starts + int(rng.integers(1, 3)) * 500_000,
            "name": "f",
            "score": rng.uniform(0, 1, n).round(3),
            "strand": rng.choice(["+", "-"], n),
        }
    ).sort_values(["chrom", "start"], kind="stable", ignore_index=True)

    kw = dict(
        features_format="bed",
        mindist=0,
        flank=int(rng.integers(2, 4)) * 1_000_000,
    )
    mode = rng.integers(0, 4)
    if mode == 0:
        kw["nshifts"] = int(rng.integers(1, 3))
        kw["seed"] = int(rng.integers(0, 100))
    elif mode == 1:
        kw["expected_df"] = exp
        kw["ooe"] = bool(rng.integers(0, 2))
    elif mode == 2:
        kw["clr_weight_name"] = None
        kw["coverage_norm"] = True
    if rng.integers(0, 2):
        kw["by_strand"] = True
        if rng.integers(0, 2):
            kw["flip_negative_strand"] = True
    if rng.integers(0, 3) == 0:
        kw["store_stripes"] = True
    if rng.integers(0, 3) == 0 and "expected_df" not in kw:
        kw["by_distance"] = True
    return feats, kw


def _host_stream(monkeypatch):
    """Route every pileup() region through the host snip stream: an
    identity per-snip hook is what sends a region there."""
    run = PileUpper.pileupsWithControl

    def with_hook(self, *args, **kw):
        kw["postprocess_snip_func"] = lambda snip: snip
        return run(self, *args, **kw)

    monkeypatch.setattr(PileUpper, "pileupsWithControl", with_hook)


@pytest.mark.parametrize("case", range(N_CASES))
def test_fuzz_backend_parity(toy, exp, case, monkeypatch):
    clr, dense, weights = toy
    rng = np.random.default_rng(1000 + case)
    feats, kw = random_case(rng, exp)

    a = pileup(clr, feats, view_df=toy_regions(), **kw)
    with monkeypatch.context() as m:
        _host_stream(m)
        b = pileup(clr, feats, view_df=toy_regions(), **kw)
    assert len(a) == len(b), kw
    key = "group"
    a = a.set_index(a[key].astype(str)).sort_index()
    b = b.set_index(b[key].astype(str)).sort_index()
    assert list(a.index) == list(b.index), kw
    for g in a.index:
        assert int(a.loc[g, "n"]) == int(b.loc[g, "n"]), (kw, g)
        da = np.asarray(a.loc[g, "data"], float)
        db = np.asarray(b.loc[g, "data"], float)
        # NaN masks must agree BEFORE flattening (a NaN-vs-0 divergence is
        # exactly the masking-parity bug class this harness exists for)
        np.testing.assert_array_equal(
            np.isnan(da), np.isnan(db), err_msg=str((kw, g))
        )
        np.testing.assert_allclose(
            np.nan_to_num(da, posinf=1e30),
            np.nan_to_num(db, posinf=1e30),
            rtol=1e-4, atol=1e-7, err_msg=str((kw, g)),
        )
        if kw.get("store_stripes"):
            ha = np.asarray(a.loc[g, "horizontal_stripe"], float)
            hb = np.asarray(b.loc[g, "horizontal_stripe"], float)
            assert ha.shape == hb.shape
            np.testing.assert_allclose(
                np.nan_to_num(ha), np.nan_to_num(hb),
                rtol=1e-4, atol=1e-7, err_msg=str((kw, g)),
            )
