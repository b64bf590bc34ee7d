"""Executable walkthrough — the analog of the reference's CLI walkthrough
notebook that CI runs as an integration smoke test (reference
.github/workflows/tests.yml:36–41 executes Walkthrough_CLI.ipynb).

Generates a synthetic cooler + stranded features, then drives every user
surface end-to-end: coolpup CLI (plain, by-strand, by-distance, stripes,
local rescale), dividepups CLI, plotpup CLI, and the Python API with an
extension hook. Runs on CPU or GPU unchanged. Exit code 0 = all good.
"""

import os
import sys
import tempfile

import numpy as np
import pandas as pd

def main():
    from coolpuppy_tpu import Cooler, pileup
    from coolpuppy_tpu.cli import coolpup_cli, dividepups_cli, plotpup_cli
    from coolpuppy_tpu.io import load_pileup_df, write_cool

    tmp = tempfile.mkdtemp(prefix="coolpuppy_tpu_walkthrough_")
    os.chdir(tmp)

    # 1. synthetic cooler (distance-decaying contacts) + stranded features
    rng = np.random.default_rng(0)
    n_bins, binsize = 2_000, 100_000
    i, j = np.triu_indices(n_bins)
    vals = rng.poisson(200.0 / (1.0 + np.abs(i - j)) + 0.2)
    keep = vals > 0
    weights = rng.uniform(0.5, 1.5, n_bins)
    weights[rng.random(n_bins) < 0.03] = np.nan
    write_cool(
        "toy.cool",
        {"chr1": n_bins * binsize},
        binsize,
        (i[keep], j[keep], vals[keep]),
        weights=weights,
    )
    clr = Cooler("toy.cool")

    centers = np.sort(rng.choice(np.arange(50, n_bins - 50), 200, False))
    feats = pd.DataFrame(
        {
            "chrom": "chr1",
            "start": centers * binsize,
            "end": centers * binsize + binsize,
            "name": ".",
            "score": 0,
            "strand": rng.choice(["+", "-"], len(centers)),
        }
    )
    feats.to_csv("features.bed", sep="\t", header=False, index=False)
    tads = pd.DataFrame(
        {
            "chrom": "chr1",
            "start": centers[:50] * binsize,
            "end": (centers[:50] + rng.integers(5, 30, 50)) * binsize,
        }
    )
    tads.to_csv("tads.bed", sep="\t", header=False, index=False)

    # 2. CLI: plain pileup with shifted controls
    coolpup_cli.main(
        "toy.cool features.bed --flank 1000000 --nshifts 2 --seed 0"
        " -o plain.clpy".split()
    )
    # 3. CLI: by-strand x by-distance
    coolpup_cli.main(
        "toy.cool features.bed --flank 1000000 --nshifts 1 --seed 0"
        " --by_strand --by_distance -o bsbd.clpy".split()
    )
    # 4. CLI: stripes
    coolpup_cli.main(
        "toy.cool features.bed --flank 1000000 --nshifts 1 --seed 0"
        " --store_stripes -o stripes.clpy".split()
    )
    # 5. CLI: local rescaled TADs
    coolpup_cli.main(
        "toy.cool tads.bed --local --rescale --rescale_size 33"
        " --rescale_flank 1 --seed 0 -o tads.clpy".split()
    )
    # 6. divide two pups
    dividepups_cli.main(["plain.clpy", "plain.clpy", "-o", "ratio.clpy"])
    # 7. plots
    plotpup_cli.main(
        "--input_pups bsbd.clpy --rows orientation --cols separation"
        " --no_score --output grid.png".split()
    )
    plotpup_cli.main(
        "--input_pups stripes.clpy --stripe corner_stripe --lineplot"
        " --no_score --output stripes.png".split()
    )

    # 8. Python API + extension hook (per-snip domain score)
    from functools import partial

    from coolpuppy_tpu.lib.numutils import get_domain_score
    from coolpuppy_tpu.lib.puputils import accumulate_values

    pups = pileup(
        clr, feats, features_format="bed", flank=1_000_000, nshifts=1, seed=0
    )
    assert int(pups.loc[pups["group"] == "all", "n"].iloc[0]) > 0

    from coolpuppy_tpu import CoordCreator, PileUpper

    cc = CoordCreator(
        tads, binsize, features_format="bed", local=True, rescale_flank=1,
        nshifts=0, mindist=0,
    )
    pu = PileUpper(clr, cc, rescale=True, rescale_size=33)

    def add_score(snip):
        snip["domain_score"] = get_domain_score(snip["data"], 1)
        return snip

    scored = pu.pileupsWithControl(
        postprocess_snip_func=add_score,
        extra_sum_funcs={
            "domain_score": partial(accumulate_values, key="domain_score")
        },
    )
    scores = scored.set_index("group").loc["all", "domain_score"]
    assert len(scores) == len(tads)

    # 9. everything wrote loadable outputs
    for f in ("plain.clpy", "bsbd.clpy", "stripes.clpy", "tads.clpy",
              "ratio.clpy"):
        df = load_pileup_df(f)
        assert len(df) > 0
    for f in ("grid.png", "stripes.png"):
        assert os.path.getsize(f) > 0

    print("walkthrough ok:", tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
