"""Property tests (SURVEY §4): linearity of accumulation — the pileup of a
feature union equals the num-weighted merge of the parts — plus golden-output
regression on a fixed-seed workload."""

import os

import numpy as np
import pandas as pd
import pytest

from coolpuppy_tpu import pileup

import golden_cases
from fixtures import make_toy_cooler, toy_features, toy_regions

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = tmp_path_factory.mktemp("cool") / "toy.cool"
    return make_toy_cooler(str(path), seed=123)


def _all_row(pup):
    row = pup[pup["group"] == "all"].iloc[0]
    return row["data"], row["num"], int(row["n"])


def test_pileup_linearity(toy):
    """pileup(A ∪ B) == merge(pileup(A), pileup(B)) via sum_pups algebra."""
    clr, dense, weights = toy
    feats = toy_features()
    fa = feats[feats["chrom"] == "chr1"]
    fb = feats[feats["chrom"] == "chr2"]
    kw = dict(
        features_format="bed",
        view_df=toy_regions(),
        mindist=0,
        flank=2_000_000,
    )
    da, numa, na = _all_row(pileup(clr, fa, **kw))
    db, numb, nb = _all_row(pileup(clr, fb, **kw))
    dab, numab, nab = _all_row(pileup(clr, feats, **kw))
    assert nab == na + nb
    np.testing.assert_allclose(numab, numa + numb)
    with np.errstate(invalid="ignore"):
        want = (np.nan_to_num(da * numa) + np.nan_to_num(db * numb)) / (
            numa + numb
        )
    np.testing.assert_allclose(dab, want, rtol=1e-5, atol=1e-9, equal_nan=True)


def test_golden_regression(toy):
    """Fixed-seed workload against a stored golden matrix — guards the whole
    pipeline (cool IO -> coords -> device kernels -> normalization) across
    refactors. Regenerate intentionally with REGEN_GOLDEN=1."""
    got = golden_cases.case_bystrand_controls(*toy)
    path = os.path.join(GOLDEN, "bystrand_controls.npz")
    if os.environ.get("REGEN_GOLDEN") or not os.path.exists(path):
        os.makedirs(GOLDEN, exist_ok=True)
        np.savez(path, **got)
        pytest.skip("golden regenerated")
    want = np.load(path)
    for k in want.files:
        np.testing.assert_allclose(
            got[k], want[k], rtol=1e-5, atol=1e-8, equal_nan=True,
            err_msg=k,
        )


def test_native_pair_enumeration_matches_numpy():
    """The C++ sweep and the numpy sweep must yield the identical pair
    sequence (chunk boundaries feed the keyed control RNG)."""
    import numpy as np

    from coolpuppy_tpu import native
    from coolpuppy_tpu.coords import CoordCreator
    import pandas as pd

    if native.enumerate_pairs is None:
        import pytest

        pytest.skip("native extension not built")

    rng = np.random.default_rng(3)
    centers = np.sort(rng.choice(100_000_000, 500, replace=False)).astype(float)
    feats = pd.DataFrame(
        {"chrom": "chr1", "start": centers - 500, "end": centers + 500}
    )
    cc = CoordCreator(
        feats, 10_000, features_format="bed", flank=50_000,
        mindist=200_000, maxdist=5_000_000, nshifts=0,
    )
    li_n, ri_n = native.enumerate_pairs(
        centers, float(cc.mindist), float(cc.maxdist)
    )
    # force the numpy path
    import coolpuppy_tpu.coords as coords_mod

    saved = coords_mod._native_enumerate_pairs
    coords_mod._native_enumerate_pairs = None
    try:
        li_p, ri_p = cc._enumerate_cis_pairs(centers)
    finally:
        coords_mod._native_enumerate_pairs = saved
    np.testing.assert_array_equal(li_n, li_p)
    np.testing.assert_array_equal(ri_n, ri_p)


def test_lazy_pair_chunks_match_eager():
    """The lazy k-sweep pair stream must produce the IDENTICAL chunk
    sequence as the eager enumeration (chunk boundaries feed the keyed
    control RNG — reproducibility contract), with bounded memory."""
    import numpy as np
    import pandas as pd

    from coolpuppy_tpu.coords import CoordCreator

    rng = np.random.default_rng(7)
    centers = np.sort(rng.choice(200_000_000, 800, replace=False)).astype(
        float
    )
    feats = pd.DataFrame(
        {"chrom": "chr1", "start": centers - 500, "end": centers + 500}
    )
    cc = CoordCreator(
        feats, 10_000, features_format="bed", flank=50_000,
        mindist=150_000, maxdist=30_000_000, nshifts=0, chunk_size=4096,
    )
    c = cc.intervals["center"].values
    eager = list(cc._iter_cis_pair_chunks(c))
    saved = CoordCreator.LAZY_PAIR_THRESHOLD
    CoordCreator.LAZY_PAIR_THRESHOLD = 0  # force the lazy sweep
    try:
        lazy = list(cc._iter_cis_pair_chunks(c))
    finally:
        CoordCreator.LAZY_PAIR_THRESHOLD = saved
    assert len(eager) == len(lazy) > 1
    for (a1, a2), (b1, b2) in zip(eager, lazy):
        np.testing.assert_array_equal(a1, b1)
        np.testing.assert_array_equal(a2, b2)
    # count estimator matches the materialized total
    total = sum(len(a) for a, _ in eager)
    assert cc._count_cis_pairs(c) == total


def test_lazy_pair_pileup_identical(tmp_path):
    """pileup() output must be identical whichever enumeration ran
    (controls included — RNG draws align through chunk boundaries)."""
    import numpy as np
    import pandas as pd

    from coolpuppy_tpu import pileup
    from coolpuppy_tpu.coords import CoordCreator

    clr, dense, weights = make_toy_cooler(str(tmp_path / "lz.cool"), seed=5)
    feats = toy_features()
    kw = dict(
        features_format="bed", view_df=toy_regions(), mindist=0,
        flank=2_000_000, nshifts=2, seed=3,
    )
    a = pileup(clr, feats, **kw)
    saved = CoordCreator.LAZY_PAIR_THRESHOLD
    CoordCreator.LAZY_PAIR_THRESHOLD = 0
    try:
        b = pileup(clr, feats, **kw)
    finally:
        CoordCreator.LAZY_PAIR_THRESHOLD = saved
    ra = a[a["group"] == "all"].iloc[0]
    rb = b[b["group"] == "all"].iloc[0]
    assert int(ra["n"]) == int(rb["n"])
    assert int(ra["control_n"]) == int(rb["control_n"])
    np.testing.assert_allclose(ra["data"], rb["data"], equal_nan=True)
