"""Bring-up contract on a machine without a GPU: chip_smoke.py refuses to
run, the compile cache follows JAX_COMPILATION_CACHE_DIR, the native
library builds from source, unknown backends raise, and the engine runs
from an in-memory cooler without h5py."""

import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("where", ["repo", "bare"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """No accelerator, or no program beside the script: non-zero exit and
    no result line."""
    cwd = REPO
    if where == "bare":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = tmp_path
    res = _run_smoke(cwd)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_cache_dir_follows_env(monkeypatch):
    import jax

    from coolpuppy_tpu import jax_setup

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    monkeypatch.setattr(jax_setup, "_done", False)
    assert jax_setup.ensure_jax_cache() == "/elsewhere/cache"
    # JAX reads the variable itself: the code sets no directory
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_is_in_checkout(monkeypatch):
    import jax

    from coolpuppy_tpu import jax_setup

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax_setup, "_done", False)
    try:
        got = jax_setup.ensure_jax_cache()
        assert got == jax_setup.DEFAULT_CACHE_DIR
        assert os.path.dirname(got) == REPO
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_native_library_builds_from_source(tmp_path, monkeypatch):
    from coolpuppy_tpu.native import build

    out = tmp_path / "_ingest.so"
    monkeypatch.setattr(build, "OUT", str(out))
    assert not build.up_to_date()
    build.build(verbose=False)
    assert build.up_to_date()
    lib = ctypes.CDLL(str(out))
    for sym in ("tile_scatter", "tile_scatter_wtri", "enumerate_pairs"):
        assert hasattr(lib, sym), sym


@pytest.mark.parametrize(
    "backend", ["pallas", "pallas-interpret", "mosaic", "triton", "cuda"]
)
def test_unknown_backend_raises(backend):
    from coolpuppy_tpu.engine.pileup import PileUpper

    with pytest.raises(ValueError, match="backend"):
        PileUpper(None, None, backend=backend)


def test_package_runs_without_h5py(tmp_path):
    """Hosts without h5py: the package imports and pileup() runs from an
    in-memory cooler, equal to the same matrix read from a .cool file."""
    code = f"""
import sys, json
sys.modules["h5py"] = None
sys.path[:0] = [{REPO!r}, {os.path.join(REPO, "tests")!r}]
import numpy as np
from fixtures import make_toy_cooler, toy_features, toy_regions
from coolpuppy_tpu import pileup
clr, _, _ = make_toy_cooler(None, seed=5)
pup = pileup(clr, toy_features(), view_df=toy_regions(), mindist=0,
             flank=2_000_000, nshifts=1, seed=0)
row = pup[pup["group"] == "all"].iloc[0]
print(json.dumps({{"n": int(row["n"]),
                  "data": np.nan_to_num(row["data"], nan=-1).tolist()}}))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=300, check=True,
    )
    got = json.loads(res.stdout.strip().splitlines()[-1])

    from fixtures import make_toy_cooler, toy_features, toy_regions

    from coolpuppy_tpu import pileup

    clr, _, _ = make_toy_cooler(str(tmp_path / "t.cool"), seed=5)
    pup = pileup(clr, toy_features(), view_df=toy_regions(), mindist=0,
                 flank=2_000_000, nshifts=1, seed=0)
    row = pup[pup["group"] == "all"].iloc[0]
    assert got["n"] == int(row["n"]) > 0
    np.testing.assert_array_equal(
        np.asarray(got["data"]), np.nan_to_num(row["data"], nan=-1)
    )
