"""Executable walkthrough #2: rescaled TAD pile-ups + domain scores — the
reference's TAD_score notebook pattern (SURVEY §3.3; reference
docs/source/Examples, CoordCreator/PileUpper with rescale and per-snip
extension hooks). CI executes this script end-to-end on CPU
(tests/test_walkthroughs.py); it runs unchanged on a GPU.

Covers the advanced API surface the first walkthrough doesn't:

1. ``CoordCreator`` + ``PileUpper`` driven directly (not via ``pileup()``)
   with ``local=True, rescale=True`` — variable-extent TADs resampled to a
   fixed 99x99 pup.
2. A per-snip ``postprocess_snip_func`` computing a domain score per TAD,
   accumulated into an output column via ``accumulate_values``
   (reference lib/puputils.py:244–253, numutils get_domain_score).
3. The same accumulate_values pattern over a precomputed FRAME column
   (TAD size class), which stays on the device kernel path.
4. Saving to .clpy, reloading, and rendering the rescaled pup.
"""

import os
import sys
import tempfile
from functools import partial

import numpy as np
import pandas as pd

if "cpu" in os.environ.get("JAX_PLATFORMS", "").lower():
    import jax

    jax.config.update("jax_platforms", "cpu")


def main():
    from coolpuppy_tpu import CoordCreator, PileUpper
    from coolpuppy_tpu.io import load_pileup_df, save_pileup_df, write_cool
    from coolpuppy_tpu.io.cool import Cooler
    from coolpuppy_tpu.lib.numutils import get_domain_score
    from coolpuppy_tpu.lib.puputils import accumulate_values

    tmp = tempfile.mkdtemp(prefix="coolpuppy_tpu_wt2_")
    binsize = 100_000
    n_bins = 2_000
    rng = np.random.default_rng(7)

    # -- synthetic cooler with TAD-like blocks ---------------------------
    print("== 1. synthetic cooler with TAD-like structure")
    edges = np.sort(rng.choice(np.arange(20, n_bins - 20), 60, replace=False))
    edges = np.concatenate([[0], edges, [n_bins]])
    i, j = np.triu_indices(n_bins)
    sep = j - i
    keep = sep < 300
    i, j, sep = i[keep], j[keep], sep[keep]
    lam = 50.0 / (1.0 + sep)
    tad_of = np.searchsorted(edges, i, side="right")
    same_tad = tad_of == np.searchsorted(edges, j, side="right")
    lam = lam * np.where(same_tad, 3.0, 1.0)
    vals = rng.poisson(lam)
    nz = vals > 0
    cool_path = os.path.join(tmp, "tads.cool")
    write_cool(
        cool_path,
        {"chr1": n_bins * binsize},
        binsize,
        (i[nz], j[nz], vals[nz]),
        weights=np.ones(n_bins),
    )
    clr = Cooler(cool_path)

    tads = pd.DataFrame(
        {
            "chrom": "chr1",
            "start": edges[1:-2] * binsize,
            "end": edges[2:-1] * binsize,
        }
    )
    tads = tads[(tads["end"] - tads["start"]) >= 5 * binsize]
    # keep TADs whose rescale window (the TAD ± its own width at
    # rescale_flank=1) stays in bounds — out-of-bounds snips are silently
    # dropped, like the reference (coolpup.py:1111–1114)
    width = tads["end"] - tads["start"]
    tads = tads[
        (tads["start"] - width >= 0)
        & (tads["end"] + width <= n_bins * binsize)
    ].reset_index(drop=True)
    print(f"   {len(tads)} TADs of {int((tads.end-tads.start).min())}"
          f"-{int((tads.end-tads.start).max())} bp")

    # -- rescaled local pileup with a per-snip domain score --------------
    print("== 2. local rescaled pileup + per-snip domain scores")
    cc = CoordCreator(
        tads,
        binsize,
        features_format="bed",
        local=True,
        rescale_flank=1,
        nshifts=0,
        mindist=0,
    )
    pu = PileUpper(
        clr, cc, expected=False, control=False, rescale=True, rescale_size=99
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
    scores = np.asarray(row["domain_score"], float)
    assert row["data"].shape == (99, 99)
    assert len(scores) == row["n"] == len(tads)
    print(f"   n={row['n']} mean domain score={np.nanmean(scores):.3f}")
    assert np.nanmean(scores) > 1.0, "TAD blocks should score above 1"

    # -- frame-column extras stay on the device kernel -------------------
    print("== 3. size-class extras via the device path")
    sized = tads.assign(
        size_class=np.where(
            (tads["end"] - tads["start"]) >= 15 * binsize, "large", "small"
        ),
        tadsize=(tads["end"] - tads["start"]) // binsize,
    )
    cc2 = CoordCreator(
        sized, binsize, features_format="bed", local=True,
        rescale_flank=1, nshifts=0, mindist=0,
    )
    pu2 = PileUpper(
        clr, cc2, expected=False, control=False, rescale=True,
        rescale_size=99,
    )
    # tadsize is a FRAME column, so accumulate_values stays on the device
    # kernel path (no per-snip host stream)
    pups2 = pu2.pileupsWithControl(
        groupby=["size_class1"],
        extra_sum_funcs={
            "tadsize1": partial(accumulate_values, key="tadsize1")
        },
    )
    by_class = pups2.set_index(pups2["group"].astype(str))
    for g in by_class.index:
        if g == "all":
            # NOTE: under groupby + extra_sum_funcs the 'all' row inherits
            # the reference's sum_pups quirk (extra_funcs REPLACE the
            # merged pup, reference puputils.py:110–112) — replicated for
            # parity; use the per-group rows
            continue
        sizes = np.asarray(by_class.loc[g, "tadsize1"], float)
        assert len(sizes) == by_class.loc[g, "n"]
        if g == "('large',)":
            assert sizes.min() >= 15
        elif g == "('small',)":
            assert sizes.max() < 15
    print(f"   groups: {sorted(by_class.index)}")

    # -- the vectorized per-snip-data hook --------------------------------
    print("== 4. postprocess_batch_func: per-snip data at batch speed")
    # fixed-size windows around TAD boundaries; the batch hook sees each
    # chunk's [N, W, W] float32 window stack aligned with the frame and
    # computes the center score as ONE vectorized line, far faster than
    # the per-snip dict stream
    bounds = pd.DataFrame(
        {
            "chrom": "chr1",
            "start": edges[1:-1] * binsize,
            "end": (edges[1:-1] + 1) * binsize,
        }
    )
    cc3 = CoordCreator(
        bounds, binsize, features_format="bed", flank=5 * binsize,
        nshifts=0, mindist=0, maxdist=100 * binsize,
    )
    pu3 = PileUpper(clr, cc3, expected=False, control=False)

    def batch_center(frame, data):
        frame = frame.copy(deep=False)
        mid = data.shape[1] // 2
        frame["center"] = np.nansum(
            data[:, mid - 1 : mid + 2, mid - 1 : mid + 2], axis=(1, 2)
        )
        return frame

    pups3 = pu3.pileupsWithControl(
        postprocess_batch_func=batch_center,
        extra_sum_funcs={"center": partial(accumulate_values, key="center")},
    )
    rb = pups3.set_index("group").loc["all"]

    # identical semantics to the per-snip dict hook, snip for snip
    def snip_center(snip):
        mid = snip["data"].shape[0] // 2
        snip["center"] = float(
            np.nansum(snip["data"][mid - 1 : mid + 2, mid - 1 : mid + 2])
        )
        return snip

    pu3b = PileUpper(clr, cc3, expected=False, control=False)
    pups3b = pu3b.pileupsWithControl(
        postprocess_snip_func=snip_center,
        extra_sum_funcs={"center": partial(accumulate_values, key="center")},
    )
    rs = pups3b.set_index("group").loc["all"]
    assert rb["n"] == rs["n"] > 0
    np.testing.assert_allclose(
        np.sort(np.asarray(rb["center"], float)),
        np.sort(np.asarray(rs["center"], float)),
        rtol=1e-5, atol=1e-6,
    )
    print(f"   n={rb['n']} batch==snip center scores verified")

    # -- save / reload / plot --------------------------------------------
    print("== 5. save .clpy, reload, plot")
    clpy = os.path.join(tmp, "tads_rescaled.clpy")
    save_pileup_df(clpy, pups)
    back = load_pileup_df(clpy)
    np.testing.assert_allclose(
        np.asarray(back["data"].iloc[0]), np.asarray(row["data"]),
        rtol=1e-6, atol=1e-9, equal_nan=True,
    )
    import matplotlib

    matplotlib.use("Agg")
    from coolpuppy_tpu.plotting import plot

    fg = plot(back, score=False, height=2)
    png = os.path.join(tmp, "tads.png")
    fg.figure.savefig(png)
    assert os.path.getsize(png) > 0
    print(f"   wrote {png}")

    print("walkthrough_tads OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
