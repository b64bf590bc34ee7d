"""Multi-device SPMD tests on the virtual 8-way CPU mesh: sharded step
equals the single-device step; invariant to the mesh factorization
(host-count invariance analog)."""

import numpy as np
import jax

from coolpuppy_tpu.ops.gather import GatherConfig, make_pileup_step
from coolpuppy_tpu.parallel import (
    make_mesh,
    make_sharded_pileup_step,
    sharded_pileup_demo_inputs,
)


def _cfg(S):
    return GatherConfig(
        W=11,
        B=64,
        S=S,
        block=min(128, S),
        capacity=8,
        cis=True,
        ignore_diags=2,
        ooe=True,
        emit_expected=False,
        coverage=True,
        stripes=False,
    )


def _single_device_reference(cfg_local, inputs, n_loci):
    """Run the same global workload on one device, summing region batches."""
    (ncolp, tiles, tmap, evec, v1, v2, c1, c2, r1, r2, dd0, cid, sm) = (
        inputs
    )
    S_global = r1.shape[1]
    cfg_full = GatherConfig(**{**cfg_local.__dict__, "S": S_global,
                               "block": cfg_local.block})
    step = make_pileup_step(cfg_full)
    total = None
    for r in range(tiles.shape[0]):
        out = step(
            tiles[r], tmap[r], ncolp, evec[r], v1[r], v2[r], c1[r], c2[r],
            r1[r], r2[r], dd0[r], cid[r], sm[r],
        )
        out = {k: np.asarray(v, np.float64) for k, v in out.items()}
        total = out if total is None else {
            k: total[k] + out[k] for k in out
        }
    return total


def test_sharded_equals_single():
    devices = jax.devices()
    assert len(devices) == 8, "conftest should provide 8 virtual CPU devices"
    mesh = make_mesh(devices, regions_axis=2)
    S_local = 128
    cfg = _cfg(S_local)
    inputs = sharded_pileup_demo_inputs(cfg, mesh, nr=2, seed=3)
    sharded = make_sharded_pileup_step(cfg, mesh)
    out = sharded(*inputs)
    out = {k: np.asarray(v, np.float64) for k, v in out.items()}

    want = _single_device_reference(cfg, inputs, mesh.shape["loci"])
    for k in want:
        np.testing.assert_allclose(out[k], want[k], rtol=2e-4, atol=1e-4)


def test_mesh_factorization_invariance():
    """1x8 and 2x4 meshes give the same accumulators for the same global
    workload — the host-count invariance the reference can't offer."""
    devices = jax.devices()
    mesh_a = make_mesh(devices, regions_axis=2)  # 2 x 4
    S_a = 128  # -> S_global = 512

    cfg_a = _cfg(S_a)
    inputs = sharded_pileup_demo_inputs(cfg_a, mesh_a, nr=2, seed=5)
    out_a = make_sharded_pileup_step(cfg_a, mesh_a)(*inputs)

    mesh_b = make_mesh(devices, regions_axis=1)  # 1 x 8
    cfg_b = _cfg(64)  # 64 * 8 = 512 global
    out_b = make_sharded_pileup_step(cfg_b, mesh_b)(*inputs)

    for k in out_a:
        np.testing.assert_allclose(
            np.asarray(out_a[k]), np.asarray(out_b[k]), rtol=2e-4, atol=1e-4
        )


# -- engine-level mesh parity: the PRODUCTION path over a real cooler --------

import sys
import os

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_toy_cooler, toy_features, toy_regions  # noqa: E402

from coolpuppy_tpu import pileup  # noqa: E402
from coolpuppy_tpu.parallel import make_loci_mesh  # noqa: E402

BINSIZE = 1_000_000


def _run_pileup(clr, mesh, **kw):
    return pileup(
        clr,
        toy_features(),
        features_format="bed",
        view_df=toy_regions(),
        flank=3 * BINSIZE,
        mindist=0,
        seed=0,
        mesh=mesh,
        **kw,
    )


def test_engine_mesh_equals_single(tmp_path):
    """pileup() through the 8-device loci mesh == single-device pileup():
    same groups, counts and data planes (the reference's Pool-over-regions +
    reduce, reference coolpup.py:1502–1531, as mesh collectives)."""
    clr, dense, weights = make_toy_cooler(str(tmp_path / "t.cool"), seed=7)
    mesh = make_loci_mesh(jax.devices())
    assert mesh.shape["loci"] == 8

    single = _run_pileup(clr, None, by_strand=True, nshifts=1)
    meshed = _run_pileup(clr, mesh, by_strand=True, nshifts=1)

    a = single.set_index("orientation")
    b = meshed.set_index("orientation")
    assert list(a.index) == list(b.index)
    for ori in a.index:
        assert a.loc[ori, "n"] == b.loc[ori, "n"]
        np.testing.assert_allclose(
            a.loc[ori, "data"], b.loc[ori, "data"], rtol=1e-4, atol=1e-7
        )


def test_rowsharded_step_equals_single():
    """Row-partitioned tiles + ppermute halo exchange == single-device step
    on the same snip workload, with per-device tile memory a fraction of the
    global stack (the row-partitioned-CSR + halo-exchange model of SURVEY
    §2c / BASELINE's north star)."""
    from scipy import sparse

    from coolpuppy_tpu.ops.tiles import build_tile_stack
    from coolpuppy_tpu.parallel import (
        build_row_partition,
        make_row_sharded_step,
        route_snips,
    )

    rng = np.random.default_rng(11)
    n_bins, B, W, S = 1024, 64, 11, 512
    ij = rng.integers(0, n_bins, (2, 6000))
    mat = sparse.coo_matrix(
        (rng.gamma(1.0, 1.0, 6000), (ij[0], ij[1])), shape=(n_bins, n_bins)
    )
    r1 = rng.integers(0, n_bins - W, S).astype(np.int32)
    r2 = np.clip(
        r1 + rng.integers(-300, 300, S), 0, n_bins - W
    ).astype(np.int32)
    dd0 = (r1 - r2).astype(np.int32)
    cid = rng.integers(0, 8, S).astype(np.int32)
    ts = build_tile_stack(mat, B, r1=r1, r2=r2, window1=W, window2=W)

    mesh = make_loci_mesh(jax.devices())
    n = mesh.shape["loci"]
    part = build_row_partition(ts, r1, n)
    assert part is not None
    # the memory claim: every device holds a band, not the region
    assert part.tiles[0].nbytes < ts.tiles.nbytes
    assert sum(
        int((part.tile_map[d] > 0).sum()) for d in range(n)
    ) >= ts.n_tiles  # own entries cover the stack (halo entries add more)

    order, counts = route_snips(part, r1)
    assert counts.sum() == S
    S_dev = 128
    assert counts.max() <= S_dev

    evec = np.linspace(1.0, 0.1, 2 * n_bins).astype(np.float32)
    valid = (rng.random(n_bins + B) > 0.05).astype(np.float32)
    cov = rng.random(n_bins + B).astype(np.float32)

    cfg = GatherConfig(
        W=W, B=B, S=S_dev, block=64, capacity=8, cis=True, ignore_diags=2,
        ooe=True, emit_expected=False, coverage=True, stripes=True,
    )
    step = make_row_sharded_step(cfg, mesh)
    r1c = np.zeros((n, S_dev), np.int32)
    r2c = np.zeros((n, S_dev), np.int32)
    dd0c = np.zeros((n, S_dev), np.int32)
    cidc = np.zeros((n, S_dev), np.int32)
    smc = np.zeros((n, S_dev), bool)
    dev_items = np.split(order, np.cumsum(counts)[:-1])
    for d in range(n):
        sel = dev_items[d]
        r1c[d, : len(sel)] = r1[sel]
        r2c[d, : len(sel)] = r2[sel]
        dd0c[d, : len(sel)] = dd0[sel]
        cidc[d, : len(sel)] = cid[sel]
        smc[d, : len(sel)] = True
    out = step(
        part.tiles, part.send_idx, part.tile_map, part.ncolp,
        evec, valid, valid, cov, cov, r1c, r2c, dd0c, cidc, smc,
    )

    cfg1 = GatherConfig(
        W=W, B=B, S=S, block=64, capacity=8, cis=True, ignore_diags=2,
        ooe=True, emit_expected=False, coverage=True, stripes=True,
    )
    from coolpuppy_tpu.ops.gather import pad_pow2

    want = make_pileup_step(cfg1)(
        ts.tiles, pad_pow2(ts.tile_map.ravel()),
        np.int32(ts.tile_map.shape[1]),
        evec, valid, valid, cov, cov,
        r1, r2, dd0, cid, np.ones(S, bool),
    )
    for k in ("sum", "num", "poison", "cov_start", "cov_end"):
        np.testing.assert_allclose(
            np.asarray(out[k]), np.asarray(want[k]), rtol=2e-4, atol=1e-5
        )
    # per-snip stripes: routed order out, invert via the routing permutation
    h = np.asarray(out["horizontal_stripe"])
    hs = np.full((S, W), np.nan)
    for d, sel in enumerate(dev_items):
        hs[sel] = h[d * S_dev : d * S_dev + len(sel)]
    np.testing.assert_allclose(
        np.nan_to_num(hs),
        np.nan_to_num(np.asarray(want["horizontal_stripe"])),
        rtol=2e-4,
        atol=1e-5,
    )


def test_engine_mesh_uses_rowshard(tmp_path):
    """The PRODUCTION engine routes mesh regions through the row-partitioned
    path and matches the single-device result (a 600-bin region spans 10
    tile rows at B=64, enough to band over 8 devices — no fallback)."""
    import pandas as pd

    from coolpuppy_tpu.coords import CoordCreator
    from coolpuppy_tpu.engine.pileup import PileUpper

    binsize = 100_000
    clr, dense, weights = make_toy_cooler(
        str(tmp_path / "t3.cool"),
        chromsizes={"chrA": 60_000_000},
        binsize=binsize,
        seed=13,
    )
    rng = np.random.default_rng(4)
    starts = np.sort(rng.choice(np.arange(60, 540), 40, replace=False))
    feats = pd.DataFrame(
        {
            "chrom": ["chrA"] * 40,
            "start": starts * binsize,
            "end": (starts + 1) * binsize,
            "name": ["x"] * 40,
            "score": [0] * 40,
            "strand": rng.choice(["+", "-"], 40),
        }
    )

    def make_pu(mesh):
        CC = CoordCreator(
            features=feats,
            resolution=binsize,
            features_format="bed",
            flank=5 * binsize,
            mindist=0,
            nshifts=0,
            seed=0,
        )
        return PileUpper(clr, CC, mesh=mesh, backend="xla")

    mesh = make_loci_mesh(jax.devices())
    pu_mesh = make_pu(mesh)
    meshed = pu_mesh.pileupsWithControl()
    assert getattr(pu_mesh, "_rowshard_regions", 0) > 0

    single = make_pu(None).pileupsWithControl()
    a = single.set_index("group").loc["all"]
    b = meshed.set_index("group").loc["all"]
    assert a["n"] == b["n"] > 0
    np.testing.assert_allclose(a["data"], b["data"], rtol=1e-4, atol=1e-7)


def test_engine_mesh_stripes_and_expected(tmp_path):
    """Mesh parity on the stripes path (per-snip sharded outputs) with
    expected normalization."""
    from fixtures import toy_expected

    clr, dense, weights = make_toy_cooler(str(tmp_path / "t2.cool"), seed=9)
    view = toy_regions()
    exp = toy_expected(clr, dense, view, weights=weights)
    mesh = make_loci_mesh(jax.devices())

    single = _run_pileup(
        clr, None, expected_df=exp, ooe=True, store_stripes=True
    )
    meshed = _run_pileup(
        clr, mesh, expected_df=exp, ooe=True, store_stripes=True
    )
    sa = single.set_index("group").loc["all"]
    sb = meshed.set_index("group").loc["all"]
    assert sa["n"] == sb["n"] > 0
    np.testing.assert_allclose(sa["data"], sb["data"], rtol=1e-4, atol=1e-7)
    # per-snip stripes reassembled from sharded outputs: same multiset
    va = np.asarray(sa["vertical_stripe"], dtype=float)
    vb = np.asarray(sb["vertical_stripe"], dtype=float)
    assert va.shape == vb.shape
    np.testing.assert_allclose(
        np.sort(np.nan_to_num(va), axis=0),
        np.sort(np.nan_to_num(vb), axis=0),
        rtol=1e-4,
        atol=1e-7,
    )


def test_rowsharded_step_emit_expected():
    """Row-partitioned step with emit_expected=True (the ooe=False expected
    mode): the exp_sum/exp_num psum keys and out_specs were previously
    untested through the halo-exchange path (ADVICE round 2)."""
    from scipy import sparse

    from coolpuppy_tpu.ops.gather import pad_pow2
    from coolpuppy_tpu.ops.tiles import build_tile_stack
    from coolpuppy_tpu.parallel import (
        build_row_partition,
        make_row_sharded_step,
        route_snips,
    )

    rng = np.random.default_rng(21)
    n_bins, B, W, S = 1024, 64, 11, 512
    ij = rng.integers(0, n_bins, (2, 6000))
    mat = sparse.coo_matrix(
        (rng.gamma(1.0, 1.0, 6000), (ij[0], ij[1])), shape=(n_bins, n_bins)
    )
    r1 = rng.integers(0, n_bins - W, S).astype(np.int32)
    r2 = np.clip(r1 + rng.integers(-200, 200, S), 0, n_bins - W).astype(
        np.int32
    )
    dd0 = (r1 - r2).astype(np.int32)
    cid = rng.integers(0, 8, S).astype(np.int32)
    ts = build_tile_stack(mat, B, r1=r1, r2=r2, window1=W, window2=W)

    mesh = make_loci_mesh(jax.devices())
    n = mesh.shape["loci"]
    part = build_row_partition(ts, r1, n)
    assert part is not None
    order, counts = route_snips(part, r1)
    S_dev = 128
    assert counts.max() <= S_dev

    evec = np.linspace(1.0, 0.1, 2 * n_bins).astype(np.float32)
    valid = (rng.random(n_bins + B) > 0.05).astype(np.float32)
    cov = np.zeros(8, np.float32)

    kw = dict(
        W=W, B=B, block=64, capacity=8, cis=True, ignore_diags=2,
        ooe=False, emit_expected=True, coverage=False, stripes=False,
    )
    step = make_row_sharded_step(GatherConfig(S=S_dev, **kw), mesh)
    dev_items = np.split(order, np.cumsum(counts)[:-1])
    r1c = np.zeros((n, S_dev), np.int32)
    r2c = np.zeros((n, S_dev), np.int32)
    dd0c = np.zeros((n, S_dev), np.int32)
    cidc = np.zeros((n, S_dev), np.int32)
    smc = np.zeros((n, S_dev), bool)
    for d in range(n):
        sel = dev_items[d]
        r1c[d, : len(sel)] = r1[sel]
        r2c[d, : len(sel)] = r2[sel]
        dd0c[d, : len(sel)] = dd0[sel]
        cidc[d, : len(sel)] = cid[sel]
        smc[d, : len(sel)] = True
    out = step(
        part.tiles, part.send_idx, part.tile_map, part.ncolp,
        evec, valid, valid, cov, cov, r1c, r2c, dd0c, cidc, smc,
    )

    want = make_pileup_step(GatherConfig(S=S, **kw))(
        ts.tiles, pad_pow2(ts.tile_map.ravel()),
        np.int32(ts.tile_map.shape[1]),
        evec, valid, valid, cov, cov,
        r1, r2, dd0, cid, np.ones(S, bool),
    )
    for k in ("sum", "num", "exp_sum", "exp_num"):
        np.testing.assert_allclose(
            np.asarray(out[k]), np.asarray(want[k]), rtol=2e-4, atol=1e-5
        )


def test_rowshard_fallback_counters(tmp_path):
    """Small regions (fewer tile rows than devices) and skewed snip loads
    fall back to replicated tiles — the fallback is counted so the memory
    win stays observable, and results stay
    correct either way."""
    import pandas as pd

    from coolpuppy_tpu.coords import CoordCreator
    from coolpuppy_tpu.engine.pileup import PileUpper

    binsize = 100_000
    clr, dense, weights = make_toy_cooler(
        str(tmp_path / "tf.cool"),
        chromsizes={"chrA": 60_000_000},
        binsize=binsize,
        seed=13,
    )
    # clustered features: nearly all snips in one tile-row band -> skew
    starts = np.concatenate(
        [np.arange(64, 104), [300, 400, 500]]
    )
    feats = pd.DataFrame(
        {
            "chrom": ["chrA"] * len(starts),
            "start": starts * binsize,
            "end": (starts + 1) * binsize,
            "name": "x",
            "score": 0,
            "strand": "+",
        }
    )

    def make_pu(mesh):
        CC = CoordCreator(
            features=feats,
            resolution=binsize,
            features_format="bed",
            flank=5 * binsize,
            mindist=0,
            nshifts=0,
            seed=0,
        )
        return PileUpper(clr, CC, mesh=mesh, backend="xla")

    mesh = make_loci_mesh(jax.devices())
    pu = make_pu(mesh)
    meshed = pu.pileupsWithControl()
    # the clustered region must NOT band (skew fallback) — counter visible
    assert getattr(pu, "_rowshard_fallbacks", 0) > 0

    single = make_pu(None).pileupsWithControl()
    a = single.set_index("group").loc["all"]
    b = meshed.set_index("group").loc["all"]
    assert a["n"] == b["n"] > 0
    np.testing.assert_allclose(a["data"], b["data"], rtol=1e-4, atol=1e-7)


# -- engine mesh parity across modes and region sizes -------------------------


def _mesh_case(tmp_path, name, chromsizes, binsize, n_feats, seed):
    """By-strand pileup with shifted controls over the 8-device mesh must
    match the single-device run: the fused step per device under shard_map
    with one psum."""
    import pandas as pd

    from coolpuppy_tpu.coords import CoordCreator
    from coolpuppy_tpu.engine.pileup import PileUpper

    clr, dense, weights = make_toy_cooler(
        str(tmp_path / name), chromsizes=chromsizes, binsize=binsize,
        seed=seed,
    )
    n_bins = min(int(np.ceil(l / binsize)) for l in chromsizes.values())
    rng = np.random.default_rng(seed)
    starts = np.sort(
        rng.choice(np.arange(10, n_bins - 10), n_feats, replace=False)
    )
    feats = pd.DataFrame(
        {
            "chrom": [list(chromsizes)[0]] * n_feats,
            "start": starts * binsize,
            "end": (starts + 1) * binsize,
            "name": "x",
            "score": 0,
            "strand": rng.choice(["+", "-"], n_feats),
        }
    )

    def run(backend, mesh):
        CC = CoordCreator(
            features=feats,
            resolution=binsize,
            features_format="bed",
            flank=3 * binsize,
            mindist=0,
            nshifts=1,
            seed=0,
        )
        pu = PileUpper(clr, CC, control=True, mesh=mesh, backend=backend)
        return pu, pu.pileupsByStrandWithControl()

    mesh = make_loci_mesh(jax.devices())
    pu_mesh, meshed = run("xla", mesh)
    _, single = run("xla", None)
    a = single.set_index("orientation")
    b = meshed.set_index("orientation")
    assert list(a.index) == list(b.index)
    for ori in a.index:
        assert a.loc[ori, "n"] == b.loc[ori, "n"]
        np.testing.assert_allclose(
            np.nan_to_num(a.loc[ori, "data"]),
            np.nan_to_num(b.loc[ori, "data"]),
            rtol=1e-4,
            atol=1e-7,
        )
    return pu_mesh


def test_engine_mesh_banded(tmp_path):
    """Large region (1200 bins = 19 tile rows at B=64): the mesh path
    composes with the row-partitioned halo exchange."""
    pu = _mesh_case(
        tmp_path, "mp1.cool", {"chrA": 120_000_000}, 100_000, 40, 5
    )
    assert getattr(pu, "_rowshard_regions", 0) > 0


def test_engine_mesh_replicated(tmp_path):
    """Small regions (fewer tile rows than devices): replicated tiles,
    snips split evenly."""
    pu = _mesh_case(
        tmp_path, "mp2.cool", {"chrA": 30_000_000}, 100_000, 30, 6
    )
    assert getattr(pu, "_rowshard_regions", 0) == 0


def test_engine_mesh_expected_and_coverage(tmp_path):
    """Mesh with OOE expected normalization and, separately, coverage_norm
    — both match the single-device run."""
    from fixtures import toy_expected
    from coolpuppy_tpu.coords import CoordCreator
    from coolpuppy_tpu.engine.pileup import PileUpper

    clr, dense, weights = make_toy_cooler(str(tmp_path / "mp3.cool"), seed=9)
    view = toy_regions()
    exp = toy_expected(clr, dense, view, weights=weights)
    mesh = make_loci_mesh(jax.devices())

    def run(backend, mesh_, **kw):
        CC = CoordCreator(
            features=toy_features(),
            resolution=BINSIZE,
            features_format="bed",
            flank=3 * BINSIZE,
            mindist=0,
            seed=0,
        )
        pu = PileUpper(
            clr, CC, view_df=view, mesh=mesh_, backend=backend, **kw
        )
        return pu.pileupsWithControl()

    for kw in (
        dict(expected=exp, ooe=True),
        dict(coverage_norm=True, clr_weight_name=None),
    ):
        meshed = run("xla", mesh, **kw)
        single = run("xla", None, **kw)
        a = single.set_index("group").loc["all"]
        b = meshed.set_index("group").loc["all"]
        assert a["n"] == b["n"] > 0
        np.testing.assert_allclose(
            np.nan_to_num(a["data"]), np.nan_to_num(b["data"]),
            rtol=1e-4, atol=1e-7,
        )


def test_engine_mesh_trans(tmp_path):
    """Mesh parity for trans pileups: scalar expected frames, rectangular
    tile stacks, rowshard banding with distinct row/col frames (reference
    trans machinery coolpup.py:999–1005, 1419–1429)."""
    from coolpuppy_tpu.coords import CoordCreator
    from coolpuppy_tpu.engine.pileup import PileUpper

    clr, dense, weights = make_toy_cooler(str(tmp_path / "tt.cool"), seed=11)

    def run(mesh):
        CC = CoordCreator(
            features=toy_features(),
            resolution=BINSIZE,
            features_format="bed",
            flank=2 * BINSIZE,
            mindist=0,
            nshifts=1,
            seed=0,
            trans=True,
        )
        pu = PileUpper(
            clr, CC, view_df=toy_regions(), control=True, mesh=mesh,
            backend="xla",
        )
        return pu.pileupsWithControl()

    meshed = run(make_loci_mesh(jax.devices()))
    single = run(None)
    a = single.set_index("group").loc["all"]
    b = meshed.set_index("group").loc["all"]
    assert a["n"] == b["n"] > 0
    np.testing.assert_allclose(
        np.nan_to_num(a["data"]), np.nan_to_num(b["data"]),
        rtol=1e-4, atol=1e-7,
    )


def test_engine_mesh_rescale(tmp_path):
    """Mesh parity for the rescale path — make_engine_sharded_rescale_step
    (reference rescale coolpup.py:1193–1234)."""
    import pandas as pd

    from coolpuppy_tpu.coords import CoordCreator
    from coolpuppy_tpu.engine.pileup import PileUpper

    clr, dense, weights = make_toy_cooler(
        str(tmp_path / "tr.cool"),
        chromsizes={"chr1": 60_000_000},
        binsize=1_000_000,
        seed=7,
        trans=False,
    )
    tads = pd.DataFrame(
        {
            "chrom": ["chr1"] * 4,
            "start": [5_000_000, 15_000_000, 30_000_000, 42_000_000],
            "end": [10_000_000, 24_000_000, 37_000_000, 55_000_000],
        }
    )

    def run(mesh):
        CC = CoordCreator(
            features=tads,
            resolution=1_000_000,
            features_format="bed",
            local=True,
            rescale_flank=1.0,
            nshifts=0,
            mindist=0,
        )
        pu = PileUpper(
            clr, CC, rescale=True, rescale_size=9, ignore_diags=2,
            mesh=mesh, backend="xla",
        )
        return pu.pileupsWithControl()

    meshed = run(make_loci_mesh(jax.devices()))
    single = run(None)
    a = single.set_index("group").loc["all"]
    b = meshed.set_index("group").loc["all"]
    assert a["n"] == b["n"] > 0
    np.testing.assert_allclose(
        np.nan_to_num(a["data"]), np.nan_to_num(b["data"]),
        rtol=1e-4, atol=1e-7,
    )


def _mesh_stripes_case(tmp_path, name, chromsizes, binsize, n_feats, seed):
    """mesh + store_stripes over the 8-device mesh must match the
    single-device run, including every per-snip stripe plane and the
    coordinate table."""
    import pandas as pd

    from coolpuppy_tpu.coords import CoordCreator
    from coolpuppy_tpu.engine.pileup import PileUpper

    clr, dense, weights = make_toy_cooler(
        str(tmp_path / name), chromsizes=chromsizes, binsize=binsize,
        seed=seed,
    )
    n_bins = min(int(np.ceil(l / binsize)) for l in chromsizes.values())
    rng = np.random.default_rng(seed)
    starts = np.sort(
        rng.choice(np.arange(10, n_bins - 10), n_feats, replace=False)
    )
    feats = pd.DataFrame(
        {
            "chrom": [list(chromsizes)[0]] * n_feats,
            "start": starts * binsize,
            "end": (starts + 1) * binsize,
        }
    )

    def run(backend, mesh):
        CC = CoordCreator(
            features=feats,
            resolution=binsize,
            features_format="bed",
            flank=3 * binsize,
            mindist=0,
            seed=0,
        )
        pu = PileUpper(
            clr, CC, store_stripes=True, mesh=mesh, backend=backend
        )
        return pu, pu.pileupsWithControl()

    mesh = make_loci_mesh(jax.devices())
    pu_mesh, meshed = run("xla", mesh)
    _, single = run("xla", None)
    a = single.set_index("group").loc["all"]
    b = meshed.set_index("group").loc["all"]
    assert a["n"] == b["n"] > 0
    np.testing.assert_allclose(
        np.nan_to_num(a["data"]), np.nan_to_num(b["data"]),
        rtol=1e-4, atol=1e-7,
    )
    # identical coordinate tables => identical snip order; then the full
    # per-snip stripe planes must agree
    ca = np.asarray(a["coordinates"], dtype=object)
    cb = np.asarray(b["coordinates"], dtype=object)
    assert ca.shape == cb.shape
    assert (ca == cb).all()
    for key in ("horizontal_stripe", "vertical_stripe"):
        np.testing.assert_allclose(
            np.nan_to_num(np.asarray(a[key], float)),
            np.nan_to_num(np.asarray(b[key], float)),
            rtol=1e-4, atol=1e-7, err_msg=key,
        )
    return pu_mesh


def test_engine_mesh_stripes_banded(tmp_path):
    pu = _mesh_stripes_case(
        tmp_path, "ms1.cool", {"chrA": 120_000_000}, 100_000, 40, 15
    )
    assert getattr(pu, "_rowshard_regions", 0) > 0


def test_engine_mesh_stripes_replicated(tmp_path):
    pu = _mesh_stripes_case(
        tmp_path, "ms2.cool", {"chrA": 30_000_000}, 100_000, 25, 16
    )
    assert getattr(pu, "_rowshard_regions", 0) == 0


def test_engine_mesh_by_window(tmp_path):
    """by-window group explosion on the mesh (one group per anchor, with
    controls) must match the single-device output per window."""
    import pandas as pd

    from coolpuppy_tpu.coords import CoordCreator
    from coolpuppy_tpu.engine.pileup import PileUpper

    clr, dense, weights = make_toy_cooler(
        str(tmp_path / "mpw.cool"), chromsizes={"chrA": 30_000_000},
        binsize=100_000, seed=7,
    )
    n_bins = 300
    rng = np.random.default_rng(7)
    starts = np.sort(
        rng.choice(np.arange(10, n_bins - 10), 24, replace=False)
    )
    feats = pd.DataFrame(
        {
            "chrom": "chrA",
            "start": starts * 100_000,
            "end": (starts + 1) * 100_000,
            "name": "x",
            "score": 0,
            "strand": rng.choice(["+", "-"], 24),
        }
    )

    def run(backend, mesh):
        CC = CoordCreator(
            features=feats, resolution=100_000, features_format="bed",
            flank=300_000, mindist=0, nshifts=1, seed=0,
        )
        pu = PileUpper(clr, CC, control=True, mesh=mesh, backend=backend)
        return pu.pileupsByWindowWithControl()

    mesh = make_loci_mesh(jax.devices())
    meshed = run("xla", mesh)
    single = run("xla", None)
    key = ["chrom", "start", "end"]
    a = single.set_index(key).sort_index()
    b = meshed.set_index(key).sort_index()
    assert list(a.index) == list(b.index)
    for idx in a.index:
        assert a.loc[idx, "n"] == b.loc[idx, "n"]
        np.testing.assert_allclose(
            np.nan_to_num(np.asarray(a.loc[idx, "data"], float)),
            np.nan_to_num(np.asarray(b.loc[idx, "data"], float)),
            rtol=1e-4, atol=1e-7,
        )
