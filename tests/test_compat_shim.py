"""The reference-import compatibility shim: the exact import lines from
the reference's example notebooks (reference
docs/source/Examples/Walkthrough_API.ipynb, TAD_score.ipynb) must work
and reach the accelerator engine."""

import numpy as np

from fixtures import make_toy_cooler, toy_features, toy_regions


def test_reference_notebook_imports(tmp_path):
    from coolpuppy import coolpup
    from coolpuppy import plotpup
    from coolpuppy.lib import numutils
    from coolpuppy.lib.puputils import divide_pups, accumulate_values
    from coolpuppy.lib.numutils import get_domain_score
    from coolpuppy.lib.io import save_pileup_df, load_pileup_df

    assert callable(coolpup.pileup)
    assert coolpup.CoordCreator is not None
    assert coolpup.PileUpper is not None
    assert callable(plotpup.plot)
    assert callable(plotpup.plot_stripes)
    assert callable(numutils.get_enrichment)
    assert callable(divide_pups)
    assert callable(accumulate_values)
    assert callable(get_domain_score)

    clr, dense, weights = make_toy_cooler(
        str(tmp_path / "shim.cool"), seed=31
    )
    pup = coolpup.pileup(
        clr, toy_features(), features_format="bed",
        view_df=toy_regions(), mindist=0, flank=2_000_000,
    )
    assert int(pup.loc[pup["group"] == "all", "n"].iloc[0]) > 0
    out = tmp_path / "shim.clpy"
    save_pileup_df(str(out), pup)
    back = load_pileup_df(str(out))
    np.testing.assert_allclose(
        np.asarray(back["data"].iloc[0]),
        np.asarray(pup["data"].iloc[0]),
        rtol=1e-6, atol=1e-9, equal_nan=True,
    )
