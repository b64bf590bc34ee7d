"""Synthetic test data: a toy mm9-like cooler with known dense ground truth.

The reference's test coolers are missing binary blobs (reference
.MISSING_LARGE_BLOBS), so tests here synthesize compatible `.cool` files and
keep the dense matrices for oracle comparisons."""

import numpy as np
import pandas as pd

from coolpuppy_tpu.io import write_cool, Cooler
from coolpuppy_tpu.io.coolwrite import cool_layout

MM9_TOY_CHROMSIZES = {"chr1": 197_195_432, "chr2": 181_748_087}


def make_toy_cooler(
    path,
    chromsizes=None,
    binsize=1_000_000,
    seed=0,
    bad_bin_frac=0.05,
    trans=True,
):
    """Random decaying-by-distance contact map. Returns (Cooler, dense dict,
    weights) where dense maps (chrom1, chrom2) -> full raw matrix block.
    ``path=None`` keeps the cooler in memory instead of a .cool file."""
    chromsizes = chromsizes or MM9_TOY_CHROMSIZES
    rng = np.random.default_rng(seed)
    chroms = list(chromsizes.keys())
    n_per = {c: int(np.ceil(l / binsize)) for c, l in chromsizes.items()}
    offsets = {}
    off = 0
    for c in chroms:
        offsets[c] = off
        off += n_per[c]
    n_bins = off

    weights = rng.uniform(0.5, 1.5, n_bins)
    bad = rng.random(n_bins) < bad_bin_frac
    weights[bad] = np.nan

    pix1, pix2, cnt = [], [], []
    dense = {}
    for ci, c1 in enumerate(chroms):
        for c2 in chroms[ci:]:
            n1, n2 = n_per[c1], n_per[c2]
            if c1 == c2:
                i, j = np.triu_indices(n1)
                lam = 100.0 / (1.0 + np.abs(i - j)) + 0.5
                vals = rng.poisson(lam)
                keep = vals > 0
                i, j, vals = i[keep], j[keep], vals[keep]
                block = np.zeros((n1, n1))
                block[i, j] = vals
                block[j, i] = vals
                dense[(c1, c2)] = block
                pix1.append(i + offsets[c1])
                pix2.append(j + offsets[c1])
                cnt.append(vals)
            elif trans:
                i, j = np.nonzero(rng.random((n1, n2)) < 0.3)
                vals = rng.poisson(2.0, len(i)) + 1
                block = np.zeros((n1, n2))
                block[i, j] = vals
                dense[(c1, c2)] = block
                pix1.append(i + offsets[c1])
                pix2.append(j + offsets[c2])
                cnt.append(vals)

    pixels = (np.concatenate(pix1), np.concatenate(pix2), np.concatenate(cnt))
    if path is None:
        src = cool_layout(chromsizes, binsize, pixels, weights=weights)
    else:
        src = write_cool(path, chromsizes, binsize, pixels, weights=weights)
    return Cooler(src), dense, weights


def toy_features():
    """The reference's toy features (reference tests/data/toy_features.bed)."""
    return pd.DataFrame(
        {
            "chrom": ["chr1", "chr1", "chr1", "chr2", "chr2", "chr2"],
            "start": [102_000_000, 105_000_000, 108_000_000] * 2,
            "end": [102_500_000, 105_500_000, 108_500_000] * 2,
            "name": ["toy"] * 6,
            "score": [0] * 6,
            "strand": ["+", "-", "+", "+", "-", "-"],
        }
    )


def toy_regions():
    """The reference's toy view (reference tests/data/CN.mm9.toy_regions.bed)."""
    return pd.DataFrame(
        {
            "chrom": ["chr1", "chr2"],
            "start": [100_000_000] * 2,
            "end": [150_000_000] * 2,
            "name": ["foo", "bar"],
        }
    )


def toy_expected(clr, dense, view_df, weights=None, value_col="balanced.avg"):
    """Compute a by-distance expected table for a view over the toy data —
    the analog of the reference's CN.mm9.toy_expected.tsv fixture."""
    rows = []
    binsize = clr.binsize
    for _, reg in view_df.iterrows():
        lo = int(reg["start"] // binsize)
        hi = int(np.ceil(reg["end"] / binsize))
        block = dense[(reg["chrom"], reg["chrom"])][lo:hi, lo:hi].astype(float)
        if weights is not None:
            o = clr.offset(reg["chrom"])
            w = weights[o + lo : o + hi]
            block = block * np.outer(w, w)
            valid = ~np.isnan(w)
        else:
            valid = np.ones(hi - lo, dtype=bool)
        n = hi - lo
        for d in range(n):
            i = np.arange(n - d)
            j = i + d
            vals = block[i, j]
            nv = int((valid[i] & valid[j]).sum())
            s = np.nansum(vals)
            rows.append(
                {
                    "region1": reg["name"],
                    "region2": reg["name"],
                    "dist": d,
                    "n_valid": nv,
                    "count.sum": np.nan,
                    "balanced.sum": s,
                    value_col: s / nv if nv > 0 else np.nan,
                }
            )
    return pd.DataFrame(rows)
