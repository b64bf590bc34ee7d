"""Benchmark: fused pile-up throughput on one chip at 1M loci.

Workload (BASELINE.json): a synthetic 20k-bin chromosome (200 Mb @ 10 kb) with
distance-decaying sparse contacts, 1M loci pairs, 21x21 windows, OOE
normalization, 4 strand groups, random flips — the loop-APA shape.

Measures the full per-chunk pipeline the engine runs (host tile-stack scatter
+ device fused gather/normalize/accumulate) in steady state, and compares
against the reference's hot-loop equivalent (scipy CSR window slicing + NaN
masking + nansum accumulation, reference coolpup.py:1104–1191) measured on a
subset of the same snips.

Prints one JSON line:
  {"metric": "snippets_per_sec", "value": ..., "unit": "snips/s",
   "vs_baseline": <speedup over the scipy reference loop>} plus details.
"""

import argparse
import json
import os
import time

import numpy as np

WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".work")

try:  # .cool files are HDF5
    import h5py  # noqa: F401

    COOLER = "file"
except ImportError:
    COOLER = "memory"  # every JSON line says so: no HDF5 ingest is timed


def _work_path(name):
    """Generated inputs live in the checkout's ignored .work directory."""
    os.makedirs(WORK, exist_ok=True)
    return os.path.join(WORK, name)


def _store(name, chromsizes, binsize, pixels, weights):
    """A Cooler of a synthetic matrix: a .cool file under .work where h5py
    is installed, else held in memory (COOLER says which)."""
    from coolpuppy_tpu.io import Cooler, write_cool
    from coolpuppy_tpu.io.coolwrite import cool_layout

    if COOLER == "memory":
        return Cooler(cool_layout(chromsizes, binsize, pixels, weights=weights))
    return Cooler(
        write_cool(_work_path(name), chromsizes, binsize, pixels,
                   weights=weights)
    )


def make_workload(n_bins=20_000, nnz_target=12_000_000, n_loci=1_000_000,
                  W=21, seed=0):
    rng = np.random.default_rng(seed)
    # distance-decay sparse matrix (upper triangle), denser near the diagonal
    d = rng.zipf(1.35, nnz_target * 2)
    d = d[d < n_bins][:nnz_target]
    i = rng.integers(0, n_bins, len(d))
    j = np.minimum(i + d, n_bins - 1)
    vals = rng.gamma(1.0, 2.0, len(d)).astype(np.float32)
    from scipy import sparse as sp

    coo = sp.coo_matrix(
        (np.concatenate([vals, vals]),
         (np.concatenate([i, j]), np.concatenate([j, i]))),
        shape=(n_bins, n_bins),
    )
    coo.sum_duplicates()
    csr = coo.tocsr()

    # loci: loop-like anchors at 100kb-2Mb separations
    a1 = rng.integers(0, n_bins - 300, n_loci)
    sep = rng.integers(10, 200, n_loci)
    a2 = np.minimum(a1 + sep, n_bins - W - 1)
    r1 = a1.astype(np.int32)
    r2 = a2.astype(np.int32)
    gid = rng.integers(0, 4, n_loci).astype(np.int32)
    flip = rng.random(n_loci) < 0.25
    valid = (rng.random(n_bins) > 0.03).astype(np.float32)
    evec = (100.0 / (1.0 + np.arange(n_bins))).astype(np.float32)
    return csr, coo, r1, r2, gid, flip, valid, evec


def bench_xla(csr, coo, r1, r2, gid, flip, valid, evec, W, chunk, repeats=3):
    import jax
    from coolpuppy_tpu.ops.gather import GatherConfig, make_pileup_step
    from coolpuppy_tpu.ops.tiles import build_tile_stack

    B = 64
    S = chunk
    cfg = GatherConfig(
        W=W, B=B, S=S, block=min(1024, S), capacity=8, cis=True,
        ignore_diags=2, ooe=True, emit_expected=False, coverage=False,
        stripes=False,
    )
    step = make_pileup_step(cfg)

    n_bins = csr.shape[0]
    pad = 1 << int(np.ceil(np.log2(n_bins + B)))
    validp = np.zeros(pad, np.float32)
    validp[:n_bins] = valid
    evecp = np.full(pad, np.nan, np.float32)
    evecp[:n_bins] = evec
    cov = np.zeros(8, np.float32)

    n_loci = len(r1)
    n_chunks = n_loci // S
    sm = np.ones(S, bool)

    # one tile stack for the whole loci set: the band of touched tiles is
    # shared across chunks, so host scatter + device transfer amortize out
    t0 = time.time()
    ts = build_tile_stack(coo, B, r1=r1, r2=r2, window1=W, window2=W)
    tiles_dev = jax.device_put(ts.tiles)
    tmap_dev = jax.device_put(ts.tile_map.ravel())
    stage_time = time.time() - t0
    ncolp = np.int32(ts.tile_map.shape[1])

    def run_all():
        outs = None
        for c in range(n_chunks):
            sl = slice(c * S, (c + 1) * S)
            out = step(
                tiles_dev, tmap_dev, ncolp,
                evecp, validp, validp, cov, cov,
                r1[sl], r2[sl], (r1[sl] - r2[sl]).astype(np.int32),
                gid[sl], sm,
            )
            outs = out
        jax.block_until_ready(outs)

    # warmup (compile)
    t0 = time.time()
    run_all()
    compile_time = time.time() - t0

    best = np.inf
    for _ in range(repeats):
        t0 = time.time()
        run_all()
        dt = time.time() - t0
        best = min(best, dt)
    snips = n_chunks * S
    return snips / (best + stage_time), best + stage_time, compile_time, snips


def make_engine_workload(name="engine.cool", n_sites=20_000, binsize=10_000,
                         seed=0, n_bins=20_000, nnz=12_000_000):
    """The engine workload: one 200 Mb chromosome at 10 kb (20,000 bins)
    with ~12M stored distance-decaying contacts, balancing weights with 3%
    bad bins, and ``n_sites`` stranded CTCF-like sites. The cooler is
    stored as ``_store`` does; returns (Cooler, features DataFrame)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    length = n_bins * binsize
    d = rng.zipf(1.35, 2 * nnz)
    d = d[d < n_bins][:nnz]
    i = rng.integers(0, n_bins, len(d))
    j = np.minimum(i + d, n_bins - 1)
    vals = rng.poisson(3.0, len(d)) + 1
    keep = i <= j
    weights = rng.uniform(0.5, 1.5, n_bins)
    weights[rng.random(n_bins) < 0.03] = np.nan
    clr = _store(
        name, {"chr1": length}, binsize, (i[keep], j[keep], vals[keep]),
        weights,
    )
    starts = np.sort(rng.choice(length - 10_000, n_sites, replace=False))
    feats = pd.DataFrame(
        {
            "chrom": "chr1",
            "start": starts,
            "end": starts + 1_000,
            "name": ".",
            "score": 0,
            "strand": rng.choice(["+", "-"], n_sites),
        }
    )
    return clr, feats


def bench_engine(n_sites=20_000, binsize=10_000, maxdist=2_000_000, seed=0):
    """Full user-facing pipeline: synthetic .cool + stranded CTCF-like sites
    -> pileup(by_strand=True) through the engine (coords, ingest, kernels,
    normalization)."""
    from coolpuppy_tpu import pileup

    clr, feats = make_engine_workload(n_sites=n_sites, binsize=binsize,
                                      seed=seed)

    def run(f):
        t0 = time.time()
        pup = pileup(
            clr,
            f,
            features_format="bed",
            flank=100_000,
            maxdist=maxdist,
            nshifts=1,
            seed=0,
            by_strand=True,
        )
        wall = time.time() - t0
        n_snips = int(
            pup.loc[pup["orientation"] == "all", "n"].iloc[0]
        ) + int(pup.loc[pup["orientation"] == "all", "control_n"].iloc[0])
        return n_snips / wall, wall, n_snips

    # warmup: kernel shapes are pinned per window size, so a small run
    # compiles everything the measured run needs (steady-state measurement;
    # compiles are a once-per-machine cost via the persistent cache)
    run(feats.iloc[: max(200, n_sites // 20)])
    return run(feats)


def _bench_cooler(seed=0):
    """Synthetic 200 Mb chromosome cooler shared by the engine-level benches
    (the engine workload's matrix)."""
    return make_engine_workload(seed=seed)[0]


def bench_rescale(n_tads=2_000, rescale_size=99, seed=0, ref_n=200):
    """Rescaled-TAD workload (BASELINE's 99x99 local rescaled pileup): engine
    throughput on variable-extent TADs (20–200 bins), vs the reference-style
    per-snip host loop (CSR slice + NaN-aware resize)."""
    import pandas as pd

    from coolpuppy_tpu import pileup

    clr = _bench_cooler()
    binsize = clr.binsize
    n_bins = clr.n_bins
    rng = np.random.default_rng(seed)
    starts = np.sort(
        rng.choice(np.arange(100, n_bins - 300), n_tads, replace=False)
    ) * binsize
    widths = rng.integers(20, 200, n_tads) * binsize
    feats = pd.DataFrame(
        {"chrom": "chr1", "start": starts, "end": starts + widths}
    )

    def run(f):
        t0 = time.time()
        pup = pileup(
            clr,
            f,
            features_format="bed",
            local=True,
            rescale=True,
            rescale_flank=1,
            rescale_size=rescale_size,
            mindist=0,
            seed=0,
        )
        return time.time() - t0, int(
            pup.loc[pup["group"] == "all", "n"].iloc[0]
        )

    # warmup with the FULL workload: the 2k TADs hit more pow2 extent
    # buckets than any subset, and each unseen bucket costs an XLA compile
    # that must not land in the measured wall; then best-of-2 steady state
    run(feats)
    wall, n_snips = run(feats)
    wall2, _ = run(feats)
    wall = min(wall, wall2)

    # reference-style loop: CSR slice -> dense, bad-bin NaN, diag mask,
    # symmetrize, NaN-aware resize (reference coolpup.py:1104–1234)
    from coolpuppy_tpu.ops.rescale import area_resize_host

    csr = clr.fetch_coo("chr1", balance="weight").tocsr()
    isnan = clr.bad_bin_mask("chr1")
    t0 = time.time()
    for k in range(min(ref_n, n_tads)):
        a = int(starts[k] // binsize)
        w = int(widths[k] // binsize)
        pad = w  # rescale_flank=1
        lo, hi = a - pad, a + w + pad
        if lo < 0 or hi > n_bins:
            continue
        data = csr[lo:hi, lo:hi].toarray().astype(float)
        data[isnan[lo:hi], :] = np.nan
        data[:, isnan[lo:hi]] = np.nan
        ii, jj = np.meshgrid(np.arange(hi - lo), np.arange(hi - lo), indexing="ij")
        data[np.abs(ii - jj) < 2] = np.nan
        import warnings as _w

        with _w.catch_warnings():
            _w.simplefilter("ignore")
            data = np.nanmean(np.dstack((data, data.T)), 2)
        nans = np.isnan(data).astype(float)
        rs = area_resize_host(np.nan_to_num(data), (rescale_size, rescale_size))
        nz = area_resize_host(nans, (rescale_size, rescale_size))
        rs[np.ceil(nz).astype(bool)] = np.nan
    ref_rate = min(ref_n, n_tads) / (time.time() - t0)
    return n_snips / wall, wall, n_snips, ref_rate


def bench_modes(n_sites=20_000, maxdist=2_000_000, seed=0):
    """Engine throughput of the modes (stripes, coverage_norm, by_window,
    bedpe, trans) beside the plain run."""
    import pandas as pd

    from coolpuppy_tpu import pileup

    clr = _bench_cooler()
    binsize = clr.binsize
    length = clr.n_bins * binsize
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(length - 10_000, n_sites, replace=False))
    feats = pd.DataFrame(
        {
            "chrom": "chr1",
            "start": starts,
            "end": starts + 1_000,
            "name": ".",
            "score": 0,
            "strand": rng.choice(["+", "-"], n_sites),
        }
    )

    def run(f, **kw):
        t0 = time.time()
        pup = pileup(
            clr,
            f,
            features_format="bed",
            flank=100_000,
            maxdist=maxdist,
            seed=0,
            **kw,
        )
        wall = time.time() - t0
        if kw.get("by_window"):
            n = int(pup.loc[pup["chrom"] == "all", "n"].iloc[0])
        else:
            n = int(pup.loc[pup["group"] == "all", "n"].iloc[0])
        return n / wall, n

    small = feats.iloc[: max(200, n_sites // 20)]
    results = {}
    for name, kw in (
        ("plain", {}),
        ("stripes", {"store_stripes": True}),
        ("coverage_norm", {"coverage_norm": True, "clr_weight_name": None}),
        # by-window: one group per anchor (2 x n_sites groups)
        ("by_window", {"by_window": True}),
    ):
        run(small, **kw)  # warmup: pinned shapes compile once
        rate_a, n1 = run(feats, **kw)
        rate_b, _ = run(feats, **kw)
        results[name] = max(rate_a, rate_b)
    results["snips"] = n1

    # bedpe: explicit pair rows through the rectangle-predicate stream.
    # Coordinate-sorted like real BEDPE files (bedtools convention; the
    # reference's loop files are sorted) — unsorted input additionally
    # pays one lexsort + frame take (coords._lex_sorted)
    n_pairs = min(2_000_000, n_sites * 100)
    a1 = rng.integers(0, clr.n_bins - 300, n_pairs)
    sep = rng.integers(12, 200, n_pairs)
    a2 = np.minimum(a1 + sep, clr.n_bins - 12)
    order = np.lexsort((a2, a1))
    a1, a2 = a1[order], a2[order]
    bedpe = pd.DataFrame(
        {
            "chrom1": "chr1",
            "start1": a1 * binsize,
            "end1": a1 * binsize + 1_000,
            "chrom2": "chr1",
            "start2": a2 * binsize,
            "end2": a2 * binsize + 1_000,
        }
    )

    def run_bedpe(f):
        t0 = time.time()
        pup = pileup(clr, f, features_format="bedpe", flank=100_000,
                     mindist=0, seed=0)
        wall = time.time() - t0
        return int(pup.loc[pup["group"] == "all", "n"].iloc[0]) / wall

    run_bedpe(bedpe.iloc[:10_000])
    results["bedpe"] = max(run_bedpe(bedpe), run_bedpe(bedpe))

    # trans: cross-chromosome feature products through the interval-product
    # predicate stream (second synthetic chromosome)
    clr2 = _bench_cooler2()
    n_t = 1_500
    t_starts1 = np.sort(rng.choice(
        clr2.chromsizes["chr1"] - 10_000, n_t, replace=False))
    t_starts2 = np.sort(rng.choice(
        clr2.chromsizes["chr2"] - 10_000, n_t, replace=False))
    tfeats = pd.DataFrame(
        {
            "chrom": ["chr1"] * n_t + ["chr2"] * n_t,
            "start": np.concatenate([t_starts1, t_starts2]),
            "end": np.concatenate([t_starts1, t_starts2]) + 1_000,
        }
    )

    def run_trans(f):
        t0 = time.time()
        pup = pileup(clr2, f, features_format="bed", flank=100_000,
                     trans=True, seed=0)
        wall = time.time() - t0
        return int(pup.loc[pup["group"] == "all", "n"].iloc[0]) / wall

    run_trans(tfeats.iloc[list(range(200)) + list(range(n_t, n_t + 200))])
    results["trans"] = max(run_trans(tfeats), run_trans(tfeats))
    return results


def _bench_cooler2(binsize=10_000, seed=1):
    """Two-chromosome cooler for the trans benchmark."""
    rng = np.random.default_rng(seed)
    n1, n2 = 10_000, 8_000
    chromsizes = {"chr1": n1 * binsize, "chr2": n2 * binsize}
    pix1, pix2, cnt = [], [], []
    for lo, n, off in ((0, n1, 0), (n1, n2, n1)):
        d = rng.zipf(1.35, 8_000_000)
        d = d[d < n][:3_000_000]
        i = rng.integers(0, n, len(d)) + off
        j = np.minimum(i + d, off + n - 1)
        v = rng.poisson(3.0, len(d)) + 1
        pix1.append(i)
        pix2.append(j)
        cnt.append(v)
    # trans block
    ti = rng.integers(0, n1, 2_000_000)
    tj = rng.integers(n1, n1 + n2, 2_000_000)
    pix1.append(ti)
    pix2.append(tj)
    cnt.append(rng.poisson(1.0, 2_000_000) + 1)
    weights = rng.uniform(0.5, 1.5, n1 + n2)
    weights[rng.random(n1 + n2) < 0.03] = np.nan
    return _store(
        "bench_trans.cool", chromsizes, binsize,
        (np.concatenate(pix1), np.concatenate(pix2), np.concatenate(cnt)),
        weights,
    )


def bench_extension(n_sites=6_000, maxdist=1_000_000, seed=0):
    """Extension-hook throughput, all three routes (reference
    accumulate_stream + _add_snip extra_funcs, coolpup.py:1236–1283,
    puputils.py:39–41, 244–253):

    - ``frame_column``: the canonical accumulate_values pattern over a
      precomputed FRAME column — stays on the device kernel, extras are a
      per-group host regrouping.
    - ``batch_hook``: postprocess_batch_func — per-snip DATA semantics,
      vectorized: the hook sees each chunk's [N, W, W] window stack
      aligned with the frame.
    - ``snip_hook``: a postprocess_snip_func that must see gathered pixel
      data one dict at a time — the per-snip Python host stream, priced
      honestly; its floor is numpy-call overhead per snip, not the
      gather (batched)."""
    from functools import partial

    import pandas as pd

    from coolpuppy_tpu import CoordCreator, PileUpper
    from coolpuppy_tpu.lib.puputils import accumulate_values

    clr = _bench_cooler()
    binsize = clr.binsize
    length = clr.n_bins * binsize
    rng = np.random.default_rng(seed)

    def make_feats(n):
        starts = np.sort(rng.choice(length - 10_000, n, replace=False))
        return pd.DataFrame(
            {
                "chrom": "chr1",
                "start": starts,
                "end": starts + 1_000,
                "name": ".",
                "score": rng.uniform(0, 1, n).round(4),
                "strand": rng.choice(["+", "-"], n),
            }
        )

    def post(snip):
        snip["center"] = float(np.nansum(snip["data"][8:13, 8:13]))
        yield snip

    def batch_post(frame, data):
        frame = frame.copy(deep=False)
        frame["center"] = np.nansum(data[:, 8:13, 8:13], axis=(1, 2))
        return frame

    def run(f, route):
        t0 = time.time()
        cc = CoordCreator(
            f, binsize, features_format="bed", flank=100_000,
            maxdist=maxdist, nshifts=0,
        )
        pu = PileUpper(clr, cc, expected=False, control=False)
        if route == "frame":
            kw = dict(
                extra_sum_funcs={
                    "score1": partial(accumulate_values, key="score1")
                }
            )
        elif route == "batch":
            kw = dict(
                postprocess_batch_func=batch_post,
                extra_sum_funcs={
                    "center": partial(accumulate_values, key="center")
                },
            )
        else:
            kw = dict(
                postprocess_snip_func=post,
                extra_sum_funcs={
                    "center": partial(accumulate_values, key="center")
                },
            )
        pups = pu.pileupsWithControl(**kw)
        n = int(pups.set_index("group").loc["all", "n"])
        return n / (time.time() - t0), n

    # frame-column pattern at the plain workload scale (device path)
    feats_big = make_feats(20_000)
    run(feats_big.iloc[:1_000], "frame")
    rate_a, n_frame = run(feats_big, "frame")
    rate_b, _ = run(feats_big, "frame")
    frame_rate = max(rate_a, rate_b)
    feats_small = make_feats(n_sites)
    # vectorized per-snip-data hook
    run(feats_small.iloc[:200], "batch")
    batch_a, n_batch = run(feats_small, "batch")
    batch_b, _ = run(feats_small, "batch")
    batch_rate = max(batch_a, batch_b)
    # per-snip dict hook (host stream)
    run(feats_small.iloc[:200], "snip")
    snip_rate, n_snip = run(feats_small, "snip")
    return frame_rate, n_frame, batch_rate, n_batch, snip_rate, n_snip


def bench_genome(n_chroms=20, bins_per=13_500, binsize=10_000,
                 n_sites=37_000, maxdist=2_000_000, nshifts=10, seed=0):
    """Reference-realistic GENOME-WIDE workload: ~2.7 Gbp over 20
    chromosomes at 10 kb (~150M stored contacts), 37k stranded CTCF-like
    sites (the scale of the reference's Bonev_CTCF beds and its
    loop_ref.np.txt golden: 10 kb, 10 shifts, by-strand) — exercises the
    multi-region pipeline (per-chrom staging prefetch + streams) rather
    than the single-region kernel loop."""
    import pandas as pd

    from coolpuppy_tpu import pileup

    chroms = [f"chr{i+1}" for i in range(n_chroms)]
    chromsizes = {c: bins_per * binsize for c in chroms}
    # cooler generation uses its OWN rng, separate from feature sampling
    rng = np.random.default_rng(seed)
    pix1, pix2, cnt = [], [], []
    off = 0
    for c in chroms:
        d = rng.zipf(1.35, 18_000_000)
        d = d[d < bins_per][:7_500_000]
        i = rng.integers(0, bins_per, len(d)) + off
        j = np.minimum(i + d, off + bins_per - 1)
        v = rng.poisson(3.0, len(d)) + 1
        pix1.append(i.astype(np.int64))
        pix2.append(j.astype(np.int64))
        cnt.append(v.astype(np.int32))
        off += bins_per
    weights = rng.uniform(0.5, 1.5, off)
    weights[rng.random(off) < 0.03] = np.nan
    clr = _store(
        "bench_genome.cool", chromsizes, binsize,
        (np.concatenate(pix1), np.concatenate(pix2), np.concatenate(cnt)),
        weights,
    )

    per = n_sites // n_chroms
    frames = []
    rng_f = np.random.default_rng(seed + 1)
    for c in chroms:
        # sample BIN positions (13.5k-element population) — replace=False
        # over the bp population permuted ~1e8 elements per chromosome
        bins_ok = np.arange(1, bins_per - 2)
        starts = np.sort(rng_f.choice(bins_ok, per, replace=False)) * binsize
        frames.append(pd.DataFrame({
            "chrom": c, "start": starts, "end": starts + 1_000,
            "name": ".", "score": 0,
            "strand": rng_f.choice(["+", "-"], per),
        }))
    feats = pd.concat(frames, ignore_index=True)

    def run(f):
        t0 = time.time()
        pup = pileup(clr, f, features_format="bed", flank=100_000,
                     maxdist=maxdist, nshifts=nshifts, seed=0,
                     by_strand=True)
        wall = time.time() - t0
        n = int(pup.loc[pup["orientation"] == "all", "n"].iloc[0]) + int(
            pup.loc[pup["orientation"] == "all", "control_n"].iloc[0]
        )
        import importlib

        _ep = importlib.import_module("coolpuppy_tpu.engine.pileup")
        phases = {
            k: round(v, 2)
            for k, v in getattr(
                getattr(_ep, "LAST_TIMERS", None), "seconds", {}
            ).items()
        }
        return n / wall, wall, n, phases

    run(feats.iloc[: per])  # warm compiles on one chrom's worth
    rate, wall, n, phases = run(feats)
    rate2, wall2, _, phases2 = run(feats)
    if rate2 > rate:
        rate, wall, phases = rate2, wall2, phases2
    return rate, wall, n, len(feats), phases


def bench_reference_loop(csr, r1, r2, valid, evec, W, n=20_000):
    """The reference's per-snip hot loop (coolpup.py:1104–1191): CSR slice ->
    dense, NaN bad rows/cols, diag mask, ooe divide, nansum-accumulate."""
    isnan = valid < 0.5
    acc = np.zeros((W, W))
    num = np.zeros((W, W), np.int64)
    ar = np.arange(W)
    ii, jj = np.meshgrid(ar, ar, indexing="ij")
    t0 = time.time()
    for s in range(n):
        a, b = int(r1[s]), int(r2[s])
        data = csr[a : a + W, b : b + W].toarray().astype(float)
        data[isnan[a : a + W], :] = np.nan
        data[:, isnan[b : b + W]] = np.nan
        D = np.abs(a - b + ii - jj)
        data[D < 2] = np.nan
        with np.errstate(divide="ignore", invalid="ignore"):
            exp = evec[np.minimum(D, len(evec) - 1)]
            data = data / exp
        acc = np.nansum([acc, data], axis=0)
        num += np.isfinite(data)
    dt = time.time() - t0
    return n / dt


def _device_info():
    """The device every result names; no GPU is an error, not a fallback
    to the CPU."""
    import subprocess

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"bench.py: JAX found no GPU (platform {devs[0].platform!r})"
        )
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "count": len(devs),
        "card": card,
    }


def _emit(device, metric, value, unit, vs_baseline, **detail):
    print(json.dumps({
        "metric": metric, "value": value, "unit": unit,
        "vs_baseline": vs_baseline, "device": device, "cooler": COOLER,
        "detail": detail,
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--loci", type=int, default=1_000_000)
    ap.add_argument("--chunk", type=int, default=65_536)
    ap.add_argument("--ref-snips", type=int, default=20_000)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument(
        "--engine",
        action="store_true",
        help="benchmark the full pileup() pipeline instead of the kernel",
    )
    ap.add_argument(
        "--rescale",
        action="store_true",
        help="benchmark the 99x99 rescaled-TAD workload",
    )
    ap.add_argument(
        "--modes",
        action="store_true",
        help="benchmark stripes / coverage_norm engine modes vs plain",
    )
    ap.add_argument(
        "--extension",
        action="store_true",
        help="host snip-stream throughput with per-snip extension hooks",
    )
    ap.add_argument(
        "--genome",
        action="store_true",
        help="genome-wide multi-chromosome workload (37k CTCF-scale sites"
        ", 20 chroms, 10 shifts, by-strand)",
    )
    args = ap.parse_args()
    if args.quick:
        args.loci, args.chunk, args.ref_snips = 131_072, 32_768, 2_000

    from coolpuppy_tpu.jax_setup import ensure_jax_cache

    ensure_jax_cache()
    device = _device_info()

    if args.genome:
        rate, wall, n, n_feats, phases = bench_genome()
        _emit(device, "genome_snippets_per_sec", round(rate), "snips/s",
              None, snips=n, features=n_feats, chroms=20, nshifts=10,
              wall_s=round(wall, 2), phase_seconds=phases)
        return

    if args.extension:
        (frame_rate, n_frame, batch_rate, n_batch, snip_rate,
         n_snip) = bench_extension()
        _emit(device, "extension_snippets_per_sec", round(frame_rate),
              "snips/s", None,
              frame_column_device_path=round(frame_rate),
              frame_column_snips=n_frame,
              batch_hook_path=round(batch_rate), batch_hook_snips=n_batch,
              snip_hook_host_path=round(snip_rate), snip_hook_snips=n_snip)
        return

    if args.rescale:
        rate, wall, n_snips, ref_rate = bench_rescale()
        _emit(device, "rescale_snippets_per_sec", round(rate), "snips/s",
              round(rate / ref_rate, 2), snips=n_snips,
              wall_s=round(wall, 2),
              ref_loop_snips_per_sec=round(ref_rate, 1))
        return

    if args.modes:
        res = bench_modes()
        _emit(device, "modes_snippets_per_sec", round(res["stripes"]),
              "snips/s", round(res["stripes"] / res["plain"], 3),
              **{k: round(v) for k, v in res.items()})
        return

    if args.engine:
        rate, wall, n_snips = bench_engine()
        _emit(device, "engine_snippets_per_sec", round(rate), "snips/s",
              None, snips=n_snips, wall_s=round(wall, 2))
        return

    W = 21
    csr, coo, r1, r2, gid, flip, valid, evec = make_workload(
        n_loci=args.loci, W=W
    )
    rate, wall, compile_time, snips = bench_xla(
        csr, coo, r1, r2, gid, flip, valid, evec, W, args.chunk
    )
    ref_rate = bench_reference_loop(
        csr, r1, r2, valid, evec, W, n=args.ref_snips
    )
    _emit(device, "snippets_per_sec", round(rate), "snips/s",
          round(rate / ref_rate, 2), loci=snips, window=W,
          wall_s=round(wall, 3), compile_s=round(compile_time, 2),
          ref_scipy_snips_per_sec=round(ref_rate),
          pixels_per_sec=round(rate * W * W))


if __name__ == "__main__":
    main()
