"""The frozen-golden workloads, shared by the CPU tests
(test_golden_modes.py, test_property.py) and by chip_smoke.py, which runs
the same cases on the GPU.

Each builder runs one fixed-seed ``pileup()`` over a toy cooler and
returns the dict of arrays that ``tests/golden/<name>.npz`` freezes. Extra
keyword arguments reach ``pileup()`` (e.g. the wire precision flags).
"""

import os

import numpy as np
import pandas as pd

from coolpuppy_tpu import pileup

from fixtures import toy_expected, toy_features, toy_regions

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

# keys compared exactly: counts, positions and coordinate strings
EXACT_KEYS = ("n", "num", "control_n", "control_num", "n_per_window",
              "starts", "coordinates")


def many_features(n_per_chrom=25, seed=11):
    """A fixed, denser feature set than toy_features so every mode
    accumulates enough snips for the comparison to be meaningful."""
    rng = np.random.default_rng(seed)
    frames = []
    for chrom in ("chr1", "chr2"):
        starts = np.sort(
            rng.choice(
                np.arange(101, 148, dtype=np.int64), n_per_chrom,
                replace=False,
            )
        ) * 1_000_000
        frames.append(
            pd.DataFrame(
                {
                    "chrom": chrom,
                    "start": starts,
                    "end": starts + 500_000,
                    "name": "g",
                    "score": 0,
                    "strand": rng.choice(["+", "-"], n_per_chrom),
                }
            )
        )
    return pd.concat(frames, ignore_index=True)


def _all_row(pup):
    return pup[pup["group"] == "all"].iloc[0]


def _plain(clr, **kw):
    return pileup(
        clr, many_features(), features_format="bed",
        view_df=toy_regions(), mindist=0, flank=3_000_000, **kw,
    )


def case_ooe(clr, dense, weights, **kw):
    exp = toy_expected(clr, dense, toy_regions(), weights=weights)
    row = _all_row(_plain(clr, expected_df=exp, ooe=True, **kw))
    return {"data": row["data"], "num": row["num"], "n": int(row["n"])}


def case_expected_emission(clr, dense, weights, **kw):
    exp = toy_expected(clr, dense, toy_regions(), weights=weights)
    row = _all_row(_plain(clr, expected_df=exp, ooe=False, **kw))
    return {
        "data": row["data"],
        "num": row["num"],
        "n": int(row["n"]),
        "control_num": row["control_num"],
    }


def case_coverage_norm(clr, dense, weights, **kw):
    row = _all_row(
        _plain(clr, clr_weight_name=None, coverage_norm=True, **kw)
    )
    return {"data": row["data"], "num": row["num"], "n": int(row["n"])}


def case_local(clr, dense, weights, **kw):
    pup = pileup(
        clr, many_features(), features_format="bed",
        view_df=toy_regions(), local=True, flank=3_000_000, **kw,
    )
    row = _all_row(pup)
    return {"data": row["data"], "n": int(row["n"])}


def case_rescale(clr, dense, weights, **kw):
    feats = many_features()
    feats = feats.assign(end=feats["start"] + 4_000_000)
    pup = pileup(
        clr, feats, features_format="bed",
        view_df=toy_regions(), local=True, rescale=True,
        rescale_flank=1, rescale_size=33, mindist=0, **kw,
    )
    row = _all_row(pup)
    return {"data": row["data"], "n": int(row["n"])}


def case_stripes(clr, dense, weights, **kw):
    row = _all_row(_plain(clr, store_stripes=True, **kw))
    coords = np.asarray(row["coordinates"], dtype=object)
    coord_strings = np.array(
        [".".join(map(str, c)) for c in coords], dtype="U80"
    )
    return {
        "data": row["data"],
        "n": int(row["n"]),
        "horizontal_stripe": np.asarray(
            row["horizontal_stripe"], dtype=np.float64
        ),
        "vertical_stripe": np.asarray(
            row["vertical_stripe"], dtype=np.float64
        ),
        "coordinates": coord_strings,
    }


def case_trans(clr, dense, weights, **kw):
    pup = pileup(
        clr, many_features(), features_format="bed",
        view_df=toy_regions(), trans=True, flank=3_000_000, **kw,
    )
    row = _all_row(pup)
    return {"data": row["data"], "num": row["num"], "n": int(row["n"])}


def case_bedpe(clr, dense, weights, **kw):
    f = many_features()
    f1 = f[f["chrom"] == "chr1"].reset_index(drop=True)
    # pair each anchor with the one 4 positions later (fixed separation set)
    k = 4
    feats = pd.DataFrame(
        {
            "chrom1": "chr1",
            "start1": f1["start"].values[:-k],
            "end1": f1["end"].values[:-k],
            "chrom2": "chr1",
            "start2": f1["start"].values[k:],
            "end2": f1["end"].values[k:],
        }
    )
    pup = pileup(
        clr, feats, features_format="bedpe",
        view_df=toy_regions(), mindist=0, flank=3_000_000, **kw,
    )
    row = _all_row(pup)
    return {"data": row["data"], "num": row["num"], "n": int(row["n"])}


def case_by_window(clr, dense, weights, **kw):
    pup = _plain(clr, by_window=True, **kw)
    body = pup[pup["chrom"] != "all"].sort_values(
        ["chrom", "start"], kind="stable"
    )
    got = {
        "n_per_window": body["n"].values.astype(np.int64),
        "starts": body["start"].values.astype(np.int64),
    }
    for i in range(3):
        got[f"data_{i}"] = body["data"].iloc[i]
    return got


def case_controls(clr, dense, weights, **kw):
    """Shifted-control normalization (keyed RNG)."""
    row = _all_row(_plain(clr, nshifts=2, seed=42, **kw))
    return {
        "data": row["data"],
        "n": int(row["n"]),
        "control_n": int(row["control_n"]),
    }


def case_bystrand_controls(clr, dense, weights, **kw):
    """By-strand groups with shifted controls on the smaller toy set."""
    pup = pileup(
        clr, toy_features(), features_format="bed",
        view_df=toy_regions(), mindist=0, flank=2_000_000,
        nshifts=2, seed=7, by_strand=True, **kw,
    )
    got = {f"data_{o}": d for o, d in zip(pup["orientation"], pup["data"])}
    got["n"] = pup.sort_values("orientation")["n"].values.astype(np.int64)
    return got


# golden name -> (toy cooler seed, builder)
CASES = {
    "mode_controls": (321, case_controls),
    "bystrand_controls": (123, case_bystrand_controls),
    "mode_ooe": (321, case_ooe),
    "mode_expected_emission": (321, case_expected_emission),
    "mode_coverage_norm": (321, case_coverage_norm),
    "mode_local": (321, case_local),
    "mode_rescale": (321, case_rescale),
    "mode_stripes": (321, case_stripes),
    "mode_by_window": (321, case_by_window),
    "mode_bedpe": (321, case_bedpe),
    "mode_trans": (321, case_trans),
}


def compare(name, got, rtol, atol):
    """Compare ``got`` with the frozen golden: counts and strings exactly,
    float planes within (rtol, atol), NaN where the golden has NaN.
    Returns the largest relative error over the float planes' finite,
    nonzero golden values."""
    want = np.load(os.path.join(GOLDEN, name + ".npz"), allow_pickle=False)
    assert sorted(want.files) == sorted(got.keys()), (
        f"golden {name}: key set changed"
    )
    worst = 0.0
    for k in want.files:
        w = want[k]
        g = np.asarray(got[k])
        if w.dtype.kind in "US":
            np.testing.assert_array_equal(
                g.astype(w.dtype.kind + "64"), w.astype(w.dtype.kind + "64"),
                err_msg=f"{name}/{k}",
            )
        elif k in EXACT_KEYS:
            np.testing.assert_array_equal(g, w, err_msg=f"{name}/{k}")
        else:
            np.testing.assert_allclose(
                g, w, rtol=rtol, atol=atol, equal_nan=True,
                err_msg=f"{name}/{k}",
            )
            sel = np.isfinite(w) & (w != 0)
            if sel.any():
                rel = np.abs(g[sel] - w[sel]) / np.abs(w[sel])
                worst = max(worst, float(rel.max()))
    return worst
