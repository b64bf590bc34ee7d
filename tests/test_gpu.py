"""On-card parity: a pile-up on the GPU, through the CLI and through
``pileup()``, must match the CPU path. Runs only where an NVIDIA GPU is
present:

    python -m pytest tests/test_gpu.py -m gpu

The test process itself stays on the CPU (conftest.py), so the GPU run is
a subprocess and holds the card alone. The CLI case needs h5py (it reads
a .cool file and writes a .clpy file) and skips without it; the
``pileup()`` case runs on an in-memory cooler there.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import json, os, sys
sys.path[:0] = [{repo!r}, {tests!r}]
import jax
import numpy as np
import pandas as pd
assert jax.devices()[0].platform == "gpu", jax.devices()
from fixtures import make_toy_cooler
from coolpuppy_tpu import pileup
feats = pd.read_table({bed!r}, header=None,
                      names=["chrom", "start", "end", "name", "score",
                             "strand"])
if {entry!r} == "cli":
    from coolpuppy_tpu.cli.coolpup_cli import main
    from coolpuppy_tpu.io.clpy import load_pileup_df
    make_toy_cooler({cool!r}, chromsizes={{"chr1": 50_000_000}},
                    binsize=10_000, seed=3)
    out = os.path.join({tmp!r}, "gpu.clpy")
    main([{cool!r}, {bed!r}] + {args!r} + ["-o", out])
    pup = load_pileup_df(out)
else:
    clr, _, _ = make_toy_cooler(None, chromsizes={{"chr1": 50_000_000}},
                                binsize=10_000, seed=3)
    pup = pileup(clr, feats, flank=100_000, nshifts=1, maxdist=1_000_000,
                 seed=0)
row = pup.iloc[0]
print(json.dumps({{"n": int(row["n"]),
                  "data": np.nan_to_num(row["data"], nan=-1).tolist()}}))
"""


def _gpu_present():
    smi = shutil.which("nvidia-smi")
    return bool(smi) and subprocess.run(
        [smi, "-L"], capture_output=True
    ).returncode == 0


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["cli", "pileup"])
def test_gpu_matches_cpu(entry, tmp_path):
    if not _gpu_present():
        pytest.skip("no NVIDIA GPU on this machine")
    if entry == "cli" and importlib.util.find_spec("h5py") is None:
        pytest.skip("h5py missing: the CLI reads .cool and writes .clpy "
                    "files, both HDF5")
    from fixtures import make_toy_cooler

    from coolpuppy_tpu import pileup

    rng = np.random.default_rng(0)
    centers = np.sort(
        rng.choice(np.arange(200, 4800) * 10_000, size=400, replace=False)
    )
    bed = tmp_path / "features.bed"
    with open(bed, "w") as f:
        for c in centers:
            strand = "+" if rng.random() < 0.5 else "-"
            f.write(f"chr1\t{c}\t{c + 10000}\tf\t0\t{strand}\n")
    args = ["--flank", "100000", "--nshifts", "1", "--maxdist", "1000000",
            "--seed", "0"]
    code = CHILD.format(
        repo=REPO, tests=os.path.join(REPO, "tests"), bed=str(bed),
        cool=str(tmp_path / "toy.cool"), tmp=str(tmp_path), args=args,
        entry=entry,
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    res = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=1200, check=True,
    )
    got = json.loads(res.stdout.strip().splitlines()[-1])

    # the same pile-up on the CPU, in this process
    import pandas as pd

    clr, _, _ = make_toy_cooler(None, chromsizes={"chr1": 50_000_000},
                                binsize=10_000, seed=3)
    feats = pd.read_table(bed, header=None, names=[
        "chrom", "start", "end", "name", "score", "strand"])
    want = pileup(clr, feats, flank=100_000, nshifts=1, maxdist=1_000_000,
                  seed=0).iloc[0]
    assert got["n"] == int(want["n"]) > 0
    np.testing.assert_allclose(
        np.asarray(got["data"]), np.nan_to_num(want["data"], nan=-1),
        rtol=1e-5, atol=1e-9,
    )
