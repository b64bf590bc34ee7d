"""Bring-up check of the pile-up engine on an NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py            # phases 0-3 on one card
    python chip_smoke.py --four     # phase 4 only: the mesh over four cards

Phase 0 checks the environment and builds the native ingest library.
Phase 1 compares the fused XLA step with the numpy oracle at real widths.
Phase 2 runs ``pileup()`` and the ``coolpup-tpu`` CLI on the engine
workload (20,000 bins, ~12M contacts, 20,000 stranded sites). Phase 3
runs every frozen golden mode of ``tests/golden``. Phase 4 runs the
engine workload over a four-device mesh against one card.

Where h5py is missing, the coolers are held in memory (``cooler:
memory`` on the phase lines) and the CLI, which reads and writes HDF5
files, is not run.

Everything is printed on earlier lines; the last line of standard output
is one JSON object. Any failure, and a JAX that finds no GPU, exits
non-zero without that line.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
WORK = None  # this run's own directory of generated inputs (see main)

try:  # .cool and .clpy files are HDF5
    import h5py
except ImportError:
    h5py = None
COOLER = "file" if h5py else "memory"

PILEUP_KW = dict(
    features_format="bed", flank=100_000, maxdist=2_000_000, nshifts=1,
    by_strand=True,
)


def log(msg):
    print(msg, flush=True)


def card_name_and_power():
    """``name, power.limit`` per card, read by nvidia-smi (no JAX here)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def peak_bytes(dev):
    return (dev.memory_stats() or {}).get("peak_bytes_in_use")


def phase0():
    import jax

    devs = jax.devices()
    log(f"[phase 0] jax {jax.__version__} devices={devs}")
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {d0.platform!r})"
        )
    log(f"[phase 0] device_kind={d0.device_kind} count={len(devs)}")
    log(f"[phase 0] card: {card_name_and_power()}")
    import pandas

    h5 = h5py.__version__ if h5py else (
        "not installed: .cool/.clpy files cannot be read or written"
    )
    log(f"[phase 0] pandas {pandas.__version__}, h5py {h5}")
    from coolpuppy_tpu.jax_setup import ensure_jax_cache

    log(f"[phase 0] compile cache: {ensure_jax_cache()}")
    from coolpuppy_tpu import native

    loaded = native.tile_scatter is not None
    log(f"[phase 0] native ingest library loaded: {loaded}")
    if not loaded:
        raise RuntimeError("native ingest library did not build or load")
    return d0


def _oracle_sums(csr, r1, r2, gid, flip, valid, evec, W, G):
    from oracle import oracle_snip

    isnan = valid < 0.5
    s = np.zeros((G, W, W))
    n = np.zeros((G, W, W))
    for a, b, g, f in zip(r1, r2, gid, flip):
        data, _ = oracle_snip(
            csr, int(a), int(b), W, W, isnan, isnan, int(a) - int(b),
            ignore_diags=2, cis=True, evec=evec, ooe=True,
        )
        if f:
            data = np.flip(data, axis=(0, 1)).T
        fin = np.isfinite(data)
        s[g] += np.where(fin, data, 0.0)
        n[g] += fin
    return s, n


def phase1(seed, n_check=20_000):
    """The fused XLA step vs the numpy oracle on a seeded sample of snips
    of the kernel workload (20,000 bins, ~12M nnz, W=21, OOE
    normalization)."""
    import jax

    from bench import make_workload
    from coolpuppy_tpu.ops.gather import (
        GatherConfig,
        make_pileup_step,
        merge_flip_banks,
        pad_pow2,
    )
    from coolpuppy_tpu.ops.tiles import build_tile_stack

    W, B, G = 21, 64, 4
    csr, coo, r1, r2, gid, flip, valid, evec = make_workload(seed=seed)
    log(f"[phase 1] workload: {csr.shape[0]} bins, nnz={csr.nnz}, W={W}")
    sel = np.sort(
        np.random.default_rng(seed).choice(len(r1), n_check, replace=False)
    )
    r1, r2, gid, flip = r1[sel], r2[sel], gid[sel], flip[sel]
    n_bins = csr.shape[0]
    pad = 1 << int(np.ceil(np.log2(n_bins + B)))
    validp = np.zeros(pad, np.float32)
    validp[:n_bins] = valid
    evecp = np.full(pad, np.nan, np.float32)
    evecp[:n_bins] = evec

    ts = build_tile_stack(coo, B, r1=r1, r2=r2, window1=W, window2=W)
    S = 1 << int(np.ceil(np.log2(n_check)))
    cfg = GatherConfig(
        W=W, B=B, S=S, block=512, capacity=2 * G, cis=True, ignore_diags=2,
        ooe=True, emit_expected=False, coverage=False, stripes=False,
    )

    def padded(a):
        out = np.zeros(S, np.int32)
        out[: len(a)] = a
        return out

    mask = np.zeros(S, bool)
    mask[:n_check] = True
    cid = (gid + G * flip).astype(np.int32)
    cov = np.zeros(8, np.float32)
    args = (
        jax.device_put(pad_pow2(ts.tiles, axis=0)),
        pad_pow2(ts.tile_map.ravel()), np.int32(ts.tile_map.shape[1]),
        evecp, validp, validp, cov, cov, padded(r1), padded(r2),
        padded((r1 - r2).astype(np.int32)), padded(cid), mask,
    )
    step = make_pileup_step(cfg)
    compiled = step.lower(*args).compile()
    log(f"[phase 1] xla step memory_analysis: {compiled.memory_analysis()}")
    out = step(*args)
    got = merge_flip_banks(
        {k: np.asarray(v, np.float64) for k, v in out.items()}, G
    )

    t0 = time.time()
    want_s, want_n = _oracle_sums(csr, r1, r2, gid, flip, valid, evec, W, G)
    log(f"[phase 1] oracle over {n_check} snips took {time.time() - t0:.1f} s")
    # f32 sums in another order than the oracle's f64 loop: rtol 1e-5
    assert got["poison"].sum() == 0
    np.testing.assert_array_equal(got["num"][:G], want_n)
    np.testing.assert_allclose(got["sum"][:G], want_s, rtol=1e-5, atol=1e-6)
    err = np.max(
        np.abs(got["sum"][:G] - want_s) / np.maximum(np.abs(want_s), 1e-30)
    )
    log(f"[phase 1] xla step == oracle: num exact, sum max rel err "
        f"{err:.3g}")


def _frames_equal(a, b, rtol, key="orientation"):
    a = a.set_index(key)
    b = b.set_index(key)
    assert list(a.index) == list(b.index), (list(a.index), list(b.index))
    for k in a.index:
        assert int(a.loc[k, "n"]) == int(b.loc[k, "n"]), k
        np.testing.assert_allclose(
            np.asarray(b.loc[k, "data"], float),
            np.asarray(a.loc[k, "data"], float),
            rtol=rtol, atol=0, equal_nan=True, err_msg=str(k),
        )


def _engine_snips(pup):
    row = pup.set_index("orientation").loc["all"]
    return int(row["n"]) + int(row["control_n"])


def _path(name):
    """A file under this run's WORK where h5py can write .cool files; None
    (an in-memory cooler) where it cannot."""
    return os.path.join(WORK, name) if h5py else None


def phase2(dev, seed):
    """pileup() and the CLI on the engine workload."""
    from bench import make_engine_workload
    from coolpuppy_tpu import pileup
    from coolpuppy_tpu.cli.coolpup_cli import main as cli_main
    from coolpuppy_tpu.io.clpy import load_pileup_df

    t0 = time.time()
    clr, feats = make_engine_workload(_path("engine.cool"), seed=seed)
    log(f"[phase 2] workload made in {time.time() - t0:.1f} s "
        f"(cooler: {COOLER}): {clr.n_bins} bins, {len(feats)} sites")
    walls = []
    for _ in range(2):
        t0 = time.time()
        pup = pileup(clr, feats, seed=seed, **PILEUP_KW)
        walls.append(time.time() - t0)
    snips = _engine_snips(pup)
    log(f"[phase 2] pileup() (cooler: {COOLER}): snips={snips} "
        f"cold={walls[0]:.2f} s warm={walls[1]:.2f} s "
        f"warm_rate={snips / walls[1]:.0f} snips/s "
        f"peak_bytes_in_use={peak_bytes(dev)}")
    assert snips > 0, snips
    for d in pup["data"]:
        assert np.asarray(d).shape == (21, 21)
        assert np.isfinite(d).any()

    if not h5py:
        log("[phase 2] CLI and .clpy round trip not run: the CLI reads "
            ".cool and writes .clpy files, both HDF5, and h5py is not "
            "installed")
        return
    bed = os.path.join(WORK, "sites.bed")
    feats.to_csv(bed, sep="\t", header=False, index=False)
    out = os.path.join(WORK, "engine.clpy")
    t0 = time.time()
    cli_main([
        clr.filename, bed, "--flank", "100000", "--maxdist", "2000000",
        "--nshifts", "1", "--by_strand", "--seed", str(seed), "-o", out,
    ])
    log(f"[phase 2] CLI wrote {os.path.basename(out)} in "
        f"{time.time() - t0:.2f} s")
    _frames_equal(pup, load_pileup_df(out), rtol=1e-6)
    log(f"[phase 2] CLI .clpy == pileup() frame; card: "
        f"{card_name_and_power()}")


def phase3():
    """Every frozen golden mode, with the exact and the default wire."""
    import golden_cases as gc
    from fixtures import make_toy_cooler

    toys = {}
    for seed in sorted({s for s, _ in gc.CASES.values()}):
        toys[seed] = make_toy_cooler(_path(f"golden_{seed}.cool"), seed=seed)
    # f32 sums in another order: 1e-5 on the exact wire. The default wire
    # ships rescale's balanced tiles as scaled f16, which rounds each value
    # by at most 2^-11 = 4.88e-4 relative; the mode's output is a
    # positive-weighted average of such values, so it keeps that bound,
    # and 4.9e-4 is its limit. The other modes stay f32 (1e-4).
    f16_modes = {"mode_rescale": 4.9e-4}
    for wire, kw, rtol in (
        ("exact", dict(tile_f16=False), 1e-5),
        ("default", {}, 1e-4),
    ):
        errs = {}
        for name, (seed, build) in gc.CASES.items():
            tol = f16_modes.get(name, rtol) if wire == "default" else rtol
            errs[name] = gc.compare(
                name, build(*toys[seed], **kw), rtol=tol, atol=1e-9
            )
        log(f"[phase 3] {len(gc.CASES)} golden modes match, {wire} wire "
            f"(cooler: {COOLER}); limit {rtol}" + (
                f", {', '.join(sorted(f16_modes))} (f16 tiles) "
                f"{f16_modes['mode_rescale']}" if wire == "default" else ""))
        log(f"[phase 3] max rel err, {wire} wire: " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()))


def phase4(seed):
    """The engine workload over a four-device loci mesh == one card."""
    import jax

    from bench import make_engine_workload
    from coolpuppy_tpu import pileup
    from coolpuppy_tpu.coords import CoordCreator
    from coolpuppy_tpu.engine.pileup import PileUpper
    from coolpuppy_tpu.expected import expected_cis
    from coolpuppy_tpu.parallel import make_loci_mesh

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"chip_smoke --four: {len(devs)} devices, need 4")
    mesh = make_loci_mesh(devs[:4])
    clr, feats = make_engine_workload(_path("engine.cool"), seed=seed)
    single = pileup(clr, feats, seed=seed, **PILEUP_KW)

    def mesh_run(features, **kw):
        CC = CoordCreator(
            features=features, resolution=clr.binsize,
            features_format="bed", flank=100_000, maxdist=2_000_000,
            seed=seed, **kw.pop("cc", {}),
        )
        pu = PileUpper(clr, CC, mesh=mesh, **kw)
        return pu

    pu = mesh_run(feats, cc=dict(nshifts=1), control=True)
    t0 = time.time()
    meshed = pu.pileupsByStrandWithControl()
    log(f"[phase 4] mesh={dict(mesh.shape)} pileup (cooler: {COOLER}) in "
        f"{time.time() - t0:.2f} s, snips={_engine_snips(meshed)}")
    _frames_equal(single, meshed, rtol=1e-5)
    log(f"[phase 4] mesh == single card; rowshard regions="
        f"{getattr(pu, '_rowshard_regions', 0)} fallbacks="
        f"{getattr(pu, '_rowshard_fallbacks', 0)}")

    sub = feats.iloc[:: 10].reset_index(drop=True)
    exp = expected_cis(clr)
    kw = dict(ooe=True, store_stripes=True)
    single_s = pileup(clr, sub, features_format="bed", flank=100_000,
                      maxdist=2_000_000, seed=seed, expected_df=exp, **kw)
    pu_s = mesh_run(sub, cc=dict(nshifts=0), expected=exp, **kw)
    meshed_s = pu_s.pileupsWithControl()
    a = single_s.set_index("group").loc["all"]
    b = meshed_s.set_index("group").loc["all"]
    assert int(a["n"]) == int(b["n"]) > 0
    np.testing.assert_allclose(
        np.asarray(b["data"], float), np.asarray(a["data"], float),
        rtol=1e-5, atol=0, equal_nan=True,
    )
    for key in ("horizontal_stripe", "vertical_stripe"):
        va = np.asarray(a[key], float)
        vb = np.asarray(b[key], float)
        assert va.shape == vb.shape, key
        np.testing.assert_allclose(
            np.sort(np.nan_to_num(vb), axis=0),
            np.sort(np.nan_to_num(va), axis=0), rtol=1e-5, atol=0,
        )
    log(f"[phase 4] stripes + expected: mesh == single card, "
        f"n={int(a['n'])}; rowshard regions="
        f"{getattr(pu_s, '_rowshard_regions', 0)} fallbacks="
        f"{getattr(pu_s, '_rowshard_fallbacks', 0)}")
    for d in devs[:4]:
        log(f"[phase 4] {d}: peak_bytes_in_use={peak_bytes(d)}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--four", action="store_true",
        help="run only the four-card mesh phase",
    )
    args = ap.parse_args(argv)
    d0 = phase0()
    global WORK
    base = os.path.join(ROOT, ".work")
    os.makedirs(base, exist_ok=True)
    WORK = tempfile.mkdtemp(prefix="chip_smoke-", dir=base)
    try:
        if args.four:
            phase4(args.seed)
        else:
            phase1(args.seed)
            phase2(d0, args.seed)
            phase3()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    import jax

    log(f"card: {card_name_and_power()}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": d0.platform,
            "kind": d0.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
