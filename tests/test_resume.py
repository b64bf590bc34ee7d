"""Checkpoint/resume of per-region-pair accumulators (SURVEY §5's natural
resume unit)."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_toy_cooler, toy_features, toy_regions  # noqa: E402

from coolpuppy_tpu import CoordCreator, PileUpper  # noqa: E402

BINSIZE = 1_000_000


def _make_pu(clr, checkpoint_dir):
    CC = CoordCreator(
        features=toy_features(),
        resolution=BINSIZE,
        features_format="bed",
        flank=3 * BINSIZE,
        mindist=0,
        nshifts=0,
        seed=0,
    )
    return PileUpper(
        clr,
        CC,
        view_df=toy_regions(),
        backend="xla",
        checkpoint_dir=checkpoint_dir,
    )


def test_checkpoint_resume(tmp_path):
    clr, dense, weights = make_toy_cooler(str(tmp_path / "t.cool"), seed=7)
    want = _make_pu(clr, None).pileupsWithControl()

    ck = str(tmp_path / "ckpt")
    pu1 = _make_pu(clr, ck)
    first = pu1.pileupsWithControl()
    pairs = pu1._region_pairs()
    files = sorted(os.listdir(ck))
    assert len(files) == len(pairs) > 1
    assert all(f.endswith(".pkl") for f in files)

    # full resume: a fresh run must reuse every checkpoint and recompute
    # nothing
    pu2 = _make_pu(clr, ck)
    calls = {"n": 0}
    orig = pu2.pileup_region

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    pu2.pileup_region = counting
    resumed = pu2.pileupsWithControl()
    assert calls["n"] == 0

    # partial resume: drop one region's checkpoint -> exactly one recompute
    os.remove(os.path.join(ck, files[0]))
    pu3 = _make_pu(clr, ck)
    calls3 = {"n": 0}
    orig3 = pu3.pileup_region

    def counting3(*a, **kw):
        calls3["n"] += 1
        return orig3(*a, **kw)

    pu3.pileup_region = counting3
    partial = pu3.pileupsWithControl()
    assert calls3["n"] == 1
    assert len(os.listdir(ck)) == len(pairs)

    a = want.set_index("group").loc["all"]
    for table in (first, resumed, partial):
        b = table.set_index("group").loc["all"]
        assert a["n"] == b["n"] > 0
        np.testing.assert_allclose(a["data"], b["data"], rtol=1e-6, atol=1e-9)
