"""Upper-triangle (SymTileStack) tile builds must reproduce the full
mirrored scatter exactly — half the scatter/upload for cis regions
(ops/tiles.py; the device twin of reference coolpup.py:1053–1057's
mirrored CSR)."""

import numpy as np

from coolpuppy_tpu.ops.tiles import (
    build_tile_stack_slab,
    build_tile_stack_slab_sym,
    expand_sym_device,
)

from fixtures import make_toy_cooler


def test_sym_slab_build_matches_full(tmp_path):
    clr, dense, weights = make_toy_cooler(
        str(tmp_path / "symslab.cool"),
        chromsizes={"chrZ": 300_000_000},
        binsize=1_000_000,
        seed=8,
    )
    slab = clr.fetch_slab(("chrZ", 0, 300_000_000),
                          ("chrZ", 0, 300_000_000), balance="weight")
    assert slab.mirror
    rng = np.random.default_rng(9)
    r1 = rng.integers(0, 250, 200).astype(np.int64)
    r2 = np.minimum(r1 + rng.integers(0, 20, 200), 250)
    full = build_tile_stack_slab(
        slab, 128, r1=r1, r2=r2, window1=9, window2=9
    )
    sym = build_tile_stack_slab_sym(
        slab, 128, r1=r1, r2=r2, window1=9, window2=9
    )
    assert not sym.diag_full
    np.testing.assert_array_equal(full.tile_map, sym.tile_map)
    got = sym.expand_host()
    want = full.tiles
    # NaN-weighted pixels poison cells identically in both builds
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               equal_nan=True)


def _toy_slab(seed):
    clr, dense, weights = make_toy_cooler(
        None, chromsizes={"chrZ": 300_000_000}, binsize=1_000_000, seed=seed,
    )
    return clr.fetch_slab(("chrZ", 0, 300_000_000),
                          ("chrZ", 0, 300_000_000), balance="weight")


def test_sym_all_tiles_build_matches_full():
    """No window list: every tile the slab's pixels touch."""
    slab = _toy_slab(12)
    full = build_tile_stack_slab(slab, 128)
    sym = build_tile_stack_slab_sym(slab, 128)
    np.testing.assert_array_equal(full.tile_map, sym.tile_map)
    np.testing.assert_allclose(
        sym.expand_host(), full.tiles, rtol=1e-5, atol=1e-6, equal_nan=True
    )


def test_expand_sym_device_matches_host():
    sym = build_tile_stack_slab_sym(_toy_slab(5), 128)
    dev = np.asarray(expand_sym_device(sym))
    host = sym.expand_host()
    np.testing.assert_allclose(dev[: host.shape[0]], host,
                               rtol=1e-6, atol=1e-6)
    assert (dev[host.shape[0]:] == 0).all()
