"""Pup (accumulated pileup) utilities — host-side post-processing on small
arrays and DataFrames (reference lib/puputils.py counterpart)."""

from __future__ import annotations

import logging
import warnings

import numpy as np
import pandas as pd

from .numutils import get_domain_score, get_enrichment, get_insulation_strength

logger = logging.getLogger("coolpuppy_tpu")


def empty_pup(shape):
    return {
        "data": np.zeros(shape),
        "horizontal_stripe": [],
        "vertical_stripe": [],
        "n": 0,
        "num": np.zeros(shape),
        "cov_start": np.zeros(shape[0]),
        "cov_end": np.zeros(shape[1]),
        "coordinates": [],
    }


def sum_pups(pup1, pup2, extra_funcs=None):
    """Monoid merge of two pups (reference lib/puputils.py:88–113)."""
    pup1 = dict(pup1)
    pup2 = dict(pup2)
    pup1["data"] = np.nan_to_num(pup1["data"])
    pup2["data"] = np.nan_to_num(pup2["data"])
    pup = {
        "data": pup1["data"] + pup2["data"],
        "cov_start": pup1["cov_start"] + pup2["cov_start"],
        "cov_end": pup1["cov_end"] + pup2["cov_end"],
        "n": pup1.get("n", 1) + pup2.get("n", 1),
        "num": pup1.get("num", np.isfinite(pup1["data"]).astype(int))
        + pup2.get("num", np.isfinite(pup2["data"]).astype(int)),
        "horizontal_stripe": list(pup1.get("horizontal_stripe", []))
        + list(pup2.get("horizontal_stripe", [])),
        "vertical_stripe": list(pup1.get("vertical_stripe", []))
        + list(pup2.get("vertical_stripe", [])),
        "coordinates": list(pup1.get("coordinates", []))
        + list(pup2.get("coordinates", [])),
    }
    for key in ("poison",):
        if key in pup1 or key in pup2:
            pup[key] = pup1.get(key, 0) + pup2.get(key, 0)
    if extra_funcs:
        for key, func in extra_funcs.items():
            pup = func(pup1, pup2)
    return pd.Series(pup)


def get_score(pup, center=3, ignore_central=3):
    """Dispatch a sensible score for the pileup kind (reference
    lib/puputils.py:44–85): central enrichment for off-diagonal, domain score
    for local rescaled, insulation strength for local."""
    if not pup["local"]:
        return get_enrichment(pup["data"], center)
    if pup["rescale"]:
        return get_domain_score(pup["data"], pup["rescale_flank"])
    return get_insulation_strength(pup["data"], ignore_central)


# per-run bookkeeping columns: excluded from the division result and from
# the metadata-mismatch comparison (they are expected to differ between runs)
_DIVIDE_BOOKKEEPING = frozenset(
    {
        "clr",
        "cooler",
        "features",
        "outname",
        "expected_file",
        "group",
        "n",
        "num",
        "control_n",
        "control_num",
        "chroms",
        "minshift",
        "maxshift",
        "mindist",
        "maxdist",
        "subset",
        "seed",
        "data",
        "horizontal_stripe",
        "vertical_stripe",
        "coordinates",
    }
)


def divide_pups(pup1, pup2):
    """Elementwise ratio of two one-row pup DataFrames — comparing two
    conditions (same semantics as reference lib/puputils.py:116–165: metadata
    mismatch warnings, data division, combined n, stripe division gated on
    identical coordinates with non-finite ratios zeroed)."""
    if len(pup1) != 1 or len(pup2) != 1:
        raise ValueError("Pileups cannot contain multiple conditions")
    top = pup1.iloc[0]
    bottom = pup2.iloc[0]

    for col in pup1.columns:
        if col in _DIVIDE_BOOKKEEPING or col not in pup2.columns:
            continue
        try:
            same = np.array_equal(
                np.sort(np.atleast_1d(np.asarray(top[col]))),
                np.sort(np.atleast_1d(np.asarray(bottom[col]))),
            )
        except Exception:
            same = True
        if not same:
            warnings.warn(
                f"Note that {col} is different between the two pileups"
            )

    out = {c: top[c] for c in pup1.columns if c not in _DIVIDE_BOOKKEEPING}
    with np.errstate(divide="ignore", invalid="ignore"):
        out["data"] = np.asarray(top["data"]) / np.asarray(bottom["data"])
    out["clrs"] = f"{top.get('clr', '')}/{bottom.get('clr', '')}"
    out["n"] = top["n"] + bottom["n"]

    if "vertical_stripe" in pup1.columns and "vertical_stripe" in pup2.columns:
        c1 = np.sort(np.asarray(top["coordinates"]).ravel())
        c2 = np.sort(np.asarray(bottom["coordinates"]).ravel())
        if c1.shape == c2.shape and bool(np.all(c1 == c2)):
            out["coordinates"] = top["coordinates"]
            for stripe in ("vertical_stripe", "horizontal_stripe"):
                with np.errstate(divide="ignore", invalid="ignore"):
                    ratio = np.asarray(top[stripe]) / np.asarray(
                        bottom[stripe]
                    )
                out[stripe] = np.where(np.isfinite(ratio), ratio, 0)
        else:
            logger.info(
                "Stripes cannot be divided, coordinates differ between pups"
            )
    return pd.DataFrame([out])


def norm_coverage(snip):
    """Divide pup data by outer(cov_start, cov_end)/mean (reference
    lib/puputils.py:168–190)."""
    coverage = np.outer(snip["cov_start"], snip["cov_end"])
    coverage = coverage / np.nanmean(coverage)
    snip["data"] = snip["data"] / coverage
    snip["data"][np.isnan(snip["data"])] = 0
    return snip


def bin_distance(snip, band_edges="default"):
    """Per-snip distance band annotation (reference lib/puputils.py:193–215)."""
    if isinstance(band_edges, str) and band_edges == "default":
        band_edges = np.append([0], 50000 * 2 ** np.arange(30))
    i = np.searchsorted(band_edges, snip["distance"])
    snip["distance_band"] = tuple(band_edges[i - 1 : i + 1])
    return snip


def bin_distance_frame(frame, band_edges="default"):
    """Vectorized distance-band annotation for a snip frame."""
    from ..coords import bin_distance_intervals

    return bin_distance_intervals(frame, band_edges)


def group_by_region_frame(frame):
    """Frame-level analog of the reference's group_by_region postprocess
    (lib/puputils.py:218–223): each snip contributes to both of its anchors'
    groups, so the frame is duplicated with group = (chrom, start, end) of
    side 1 and side 2."""
    f1 = frame.copy()
    f1["group"] = list(
        zip(f1["chrom1"], f1["start1"], f1["end1"])
    )
    f2 = frame.copy()
    f2["group"] = list(
        zip(f2["chrom2"], f2["start2"], f2["end2"])
    )
    return pd.concat([f1, f2]).reset_index(drop=True)


# per-snip-dict name from the reference API (lib/puputils.py:218–223);
# the engine's frame-level hook is group_by_region_frame
group_by_region = group_by_region_frame


def _as_list(v):
    return v if isinstance(v, list) else [v]


def accumulate_values(dict1, dict2, key):
    """extra_sum_funcs helper: collect every ``key`` value flowing through the
    accumulator into one flat list (reference lib/puputils.py:244–253). Use as
    ``extra_sum_funcs={"score": partial(accumulate_values, key="score")}``.

    Unlike the reference (which rebuilds the list with ``+`` on every snip
    — O(n²) across a large group's stream), the accumulator list is
    extended in place; ``dict2``'s value is never aliased."""
    assert key in dict2, f"{key} not in dict2"
    cur = dict1.get(key)
    add = dict2[key]
    add = add if isinstance(add, list) else [add]
    if cur is None:
        dict1[key] = list(add)
    elif isinstance(cur, list):
        cur.extend(add)
    else:
        dict1[key] = [cur] + add
    return dict1


def _add_snip(outdict, key, snip, extra_funcs=None):
    """Fold one snip dict into the per-group accumulator dict — the host-side
    streaming accumulation used by the extension path (same semantics as
    reference lib/puputils.py:12–41: nansum data/cov, per-pixel finite counts,
    stripe/coordinate lists, then user extra_funcs)."""
    pup = outdict.get(key)
    if pup is None:
        outdict[key] = pup = {
            "data": np.asarray(snip["data"], dtype=float),
            "cov_start": np.asarray(snip["cov_start"], dtype=float),
            "cov_end": np.asarray(snip["cov_end"], dtype=float),
            "num": np.isfinite(snip["data"]).astype(int),
            "n": 1,
            "horizontal_stripe": [snip["horizontal_stripe"]],
            "vertical_stripe": [snip["vertical_stripe"]],
            "coordinates": [snip["coordinates"]],
        }
    else:
        pup["data"] = np.nansum([pup["data"], snip["data"]], axis=0)
        pup["cov_start"] = np.nansum(
            [pup["cov_start"], snip["cov_start"]], axis=0
        )
        pup["cov_end"] = np.nansum([pup["cov_end"], snip["cov_end"]], axis=0)
        pup["num"] = pup["num"] + np.isfinite(snip["data"]).astype(int)
        pup["n"] += 1
        pup["horizontal_stripe"].append(snip["horizontal_stripe"])
        pup["vertical_stripe"].append(snip["vertical_stripe"])
        pup["coordinates"].append(snip["coordinates"])
    if extra_funcs:
        for _key, func in extra_funcs.items():
            outdict[key] = func(outdict[key], snip)


def _add_snip_batch(outdict, key, snips, extra_funcs=None):
    """Batched `_add_snip`: one stacked nansum per flush instead of a
    [2, W, W] nansum allocation per snip (per-snip numpy overhead, not
    the hook, set the pace of the host extension stream).
    Final accumulators are identical (nansum over the stack == chained
    pairwise nansum: NaN contributes 0 either way, +inf poison survives,
    a single-snip group keeps its NaNs via the per-snip fold). Extra
    funcs still run per snip, in stream order, after the batch merge.
    Falls back to the per-snip fold on heterogeneous data shapes (a hook
    may replace `data` arbitrarily)."""
    if len(snips) == 1:
        _add_snip(outdict, key, snips[0], extra_funcs=extra_funcs)
        return
    m = len(snips)
    d0 = np.asarray(snips[0]["data"], dtype=float)
    try:
        # preallocated fill: np.stack's per-array machinery cost ~6 us
        # per small snip plane
        datas = np.empty((m,) + d0.shape, dtype=float)
        for i, s in enumerate(snips):
            datas[i] = s["data"]
        c0 = np.asarray(snips[0]["cov_start"], dtype=float)
        e0 = np.asarray(snips[0]["cov_end"], dtype=float)
        cs = np.empty((m,) + c0.shape, dtype=float)
        ce = np.empty((m,) + e0.shape, dtype=float)
        for i, s in enumerate(snips):
            cs[i] = s["cov_start"]
            ce[i] = s["cov_end"]
    except ValueError:
        for s in snips:
            _add_snip(outdict, key, s, extra_funcs=extra_funcs)
        return
    dsum = np.nansum(datas, axis=0)
    dnum = np.isfinite(datas).sum(axis=0)
    cssum = np.nansum(cs, axis=0)
    cesum = np.nansum(ce, axis=0)
    hs = [s["horizontal_stripe"] for s in snips]
    vs = [s["vertical_stripe"] for s in snips]
    coords = [s["coordinates"] for s in snips]
    pup = outdict.get(key)
    if pup is None:
        outdict[key] = pup = {
            "data": dsum,
            "cov_start": cssum,
            "cov_end": cesum,
            "num": dnum,
            "n": len(snips),
            "horizontal_stripe": hs,
            "vertical_stripe": vs,
            "coordinates": coords,
        }
    else:
        pup["data"] = np.nansum([pup["data"], dsum], axis=0)
        pup["cov_start"] = np.nansum([pup["cov_start"], cssum], axis=0)
        pup["cov_end"] = np.nansum([pup["cov_end"], cesum], axis=0)
        pup["num"] = pup["num"] + dnum
        pup["n"] += len(snips)
        pup["horizontal_stripe"].extend(hs)
        pup["vertical_stripe"].extend(vs)
        pup["coordinates"].extend(coords)
    if extra_funcs:
        for s in snips:
            for _key, func in extra_funcs.items():
                outdict[key] = func(outdict[key], s)


def collapse_snips(obj):
    """Flatten arbitrarily nested snip containers (generators, lists) into a
    stream of snip dicts — per-snip postprocess hooks may yield several copies
    of a snip (e.g. one per anchor window, reference coolpup.py:1264)."""
    if isinstance(obj, (dict, pd.Series)):
        yield obj
    else:
        for item in obj:
            yield from collapse_snips(item)
