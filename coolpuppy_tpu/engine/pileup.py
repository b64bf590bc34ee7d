"""The pile-up engine: PileUpper + pileup().

API counterpart of the reference's PileUpper / pileup()
(reference coolpup.py:752–2279), re-architected for an accelerator: per
region pair the host builds a block-sparse tile stack and vectorized snip
index arrays, the device runs the fused gather/normalize/accumulate XLA
step (ops/gather.py; ops/rescale.py for rescaled windows), and
per-(kind, group) accumulators come back as fixed-shape arrays which the host
finishes with the reference's normalization algebra (division by shifted
controls or expected, coverage normalization, local symmetrization).
"""

from __future__ import annotations

import contextlib
import logging
import os
import pickle
import re as _re
import warnings
from functools import reduce, partial

import numpy as np
import pandas as pd

from ..coords import (
    CoordCreator,
    bin_distance_intervals,
    flip_mark_intervals,
    swap_paired_columns_for_flipped,
)
from ..genomics.intervals import (
    make_cooler_view,
    make_viewframe,
    natsorted,
    sort_bedframe,
    is_compatible_viewframe,
    is_valid_expected,
)
from ..lib.numutils import _copy_array_halves
from ..lib.puputils import (
    _add_snip,
    _add_snip_batch,
    collapse_snips,
    empty_pup,
    group_by_region_frame,
    norm_coverage,
    sum_pups,
)
from ..ops.gather import GatherConfig, make_pileup_step, merge_flip_banks
from ..ops.tiles import build_tile_stack_slab, build_tile_stack_slab_sym
from ..ops.rescale import RescaleConfig, make_rescale_step
from .. import coverage as coverage_mod

logger = logging.getLogger("coolpuppy_tpu")

# paired column bases that index the gather and must NOT be swapped when
# ignore_group_order flips a snip: the gather uses the original orientation
# plus an in-kernel anti-transpose
_GATHER_BASES = (
    "stBin",
    "endBin",
    "exp_start",
    "exp_end",
    "chrom",
    "start",
    "end",
    "center",
)


# PileUpper's ``backend``: every value runs the fused XLA step
BACKENDS = ("auto", "xla")


def _next_pow2(x):
    return 1 << max(0, int(np.ceil(np.log2(max(1, int(x))))))


def _accumulate_values_frame_keys(extra_sum_funcs):
    """If every extra_sum_func is the canonical ``accumulate_values``
    pattern (a functools.partial of lib.puputils.accumulate_values with a
    ``key``), return {output_key: snip_key} so the engine can stay on the
    device kernel and collect the values from FRAME columns instead of
    per-snip dicts (reference puputils.py:244–253 collects precomputed
    values; only hooks that must see gathered pixel data need the host
    stream). Returns None when any hook is opaque."""
    import functools

    from ..lib.puputils import accumulate_values

    keys = {}
    for outkey, func in (extra_sum_funcs or {}).items():
        if not isinstance(func, functools.partial):
            return None
        if func.func is not accumulate_values:
            return None
        if func.args:
            return None
        kw = dict(func.keywords or {})
        snip_key = kw.pop("key", None)
        if kw or snip_key is None:
            return None
        keys[outkey] = snip_key
    return keys


def _orientation_labels(pups):
    """'strand1strand2' labels with the all-group collapsed to 'all'."""
    labels = pups["strand1"].astype(str) + pups["strand2"].astype(str)
    return labels.where(labels != "allall", "all")


def _separation_label(band):
    """Human-readable separation text for one distance-band tuple (the
    label format the plot facets key on)."""
    if band == "all":
        return "all"
    lo = band[0] / 1_000_000
    if len(band) < 2:
        return f"{lo}Mb+"
    return f"{lo}Mb-\n{band[1] / 1_000_000}Mb"


class PileUpper:
    """See reference coolpup.py:752–836 for parameter semantics; the
    constructor surface is the same, plus device knobs (chunk_size,
    tile_size)."""

    def __init__(
        self,
        clr,
        CC,
        *,
        view_df=None,
        clr_weight_name="weight",
        expected=False,
        expected_value_col="balanced.avg",
        ooe=True,
        control=False,
        coverage_norm=False,
        rescale=False,
        rescale_size=99,
        flip_negative_strand=False,
        ignore_diags=2,
        store_stripes=False,
        tile_f16=True,
        nproc=1,
        chunk_size=32768,
        tile_size=None,
        checkpoint_dir=None,
        trace_dir=None,
        backend="auto",
        mesh=None,
    ):
        if backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {backend!r}"
            )
        self.clr = clr
        self.resolution = clr.binsize
        self.CC = CC
        assert self.resolution == self.CC.resolution
        # mirrored CC attributes (reference coolpup.py:841 merges __dict__)
        for attr in (
            "flank",
            "rescale_flank",
            "minshift",
            "maxshift",
            "nshifts",
            "mindist",
            "maxdist",
            "local",
            "subset",
            "seed",
            "trans",
            "kind",
            "final_chroms",
        ):
            setattr(self, attr, getattr(CC, attr))
        self.clr_weight_name = clr_weight_name
        self.expected = expected
        self.expected_value_col = expected_value_col
        self.ooe = ooe
        self.control = control
        self.pad_bins = self.CC.flank // self.resolution
        self.coverage_norm = coverage_norm
        self.rescale = rescale
        self.rescale_size = rescale_size
        self.flip_negative_strand = flip_negative_strand
        self.ignore_diags = ignore_diags
        self.store_stripes = store_stripes
        # float16 TILE upload (host->device) of the rescale stacks. Safety
        # is value-gated per region
        # (ops/tiles.cast_tiles_f16): raw counts ship f16 only when the
        # round-trip is bit-exact; balanced values at <=4.9e-4 relative
        self.tile_f16 = tile_f16
        self.nproc = nproc
        self.chunk_size = int(chunk_size)
        self.tile_size = tile_size
        self.checkpoint_dir = checkpoint_dir
        self.trace_dir = trace_dir
        self.backend = backend
        # multi-chip: a jax.sharding.Mesh with a "loci" axis shards every
        # region's snip stream across devices and psums the accumulators
        # (parallel/mesh.py); "auto" builds a 1D mesh over all local devices
        if isinstance(mesh, str) and mesh == "auto":
            from ..parallel.mesh import make_loci_mesh

            mesh = make_loci_mesh()
        self.mesh = mesh
        self._timers = None
        from ..jax_setup import ensure_jax_cache

        ensure_jax_cache()

        if view_df is None:
            self.view_df = make_cooler_view(clr)
        else:
            self.view_df = make_viewframe(view_df, check_bounds=clr.chromsizes)

        self.expected_vectors = {}
        self.expected_df = None
        if self.expected is not None and self.expected is not False:
            expected_df = self.expected
            expected_df = expected_df[
                expected_df["region1"].isin(self.view_df["name"])
                & expected_df["region2"].isin(self.view_df["name"])
            ].reset_index(drop=True)
            if self.control:
                warnings.warn(
                    "Can't do both expected and control shifts; "
                    "defaulting to expected",
                    stacklevel=2,
                )
                self.control = False
            if self.trans:
                is_valid_expected(
                    expected_df,
                    "trans",
                    self.view_df,
                    verify_cooler=clr,
                    expected_value_cols=[self.expected_value_col],
                    raise_errors=True,
                )
                self.expected_df = expected_df
            else:
                expected_df = expected_df[
                    expected_df["region1"] == expected_df["region2"]
                ].reset_index(drop=True)
                is_valid_expected(
                    expected_df,
                    "cis",
                    self.view_df,
                    verify_cooler=clr,
                    expected_value_cols=[self.expected_value_col],
                    raise_errors=True,
                )
                self.expected_df = expected_df
                for name, sub in expected_df.groupby("region1", observed=True):
                    sub = sub.sort_values("dist")
                    vec = np.full(int(sub["dist"].max()) + 1, np.nan)
                    vec[sub["dist"].astype(int).values] = sub[
                        self.expected_value_col
                    ].values
                    self.expected_vectors[name] = vec
            self.expected = True

        self.view_df = self.view_df.set_index("name")
        self.view_df_extents = {}
        for region_name, region in self.view_df.iterrows():
            lo, hi = self.clr.extent(region)
            chroffset = self.clr.offset(region.iloc[0])
            self.view_df_extents[region_name] = lo - chroffset, hi - chroffset

        self.chroms = natsorted(
            set(self.CC.final_chroms) & set(self.clr.chromnames)
        )
        self.view_df = self.view_df[self.view_df["chrom"].isin(self.chroms)]
        if self.view_df["chrom"].unique().shape[0] == 0:
            raise ValueError(
                "No chromosomes are in common between the coordinate "
                "file and the cooler file"
            )
        if self.trans and self.view_df["chrom"].unique().shape[0] < 2:
            raise ValueError("Trying to do trans with fewer than two chromosomes")

        if self.coverage_norm is True or self.coverage_norm == "total":
            self.coverage_norm = "cov_tot_raw"
        elif self.coverage_norm == "cis":
            self.coverage_norm = "cov_cis_raw"
        if self.coverage_norm and self.clr_weight_name:
            raise ValueError(
                "Can't do coverage normalization when clr_weight_name is provided"
            )
        if (
            self.coverage_norm
            and self.coverage_norm not in self.clr.bins().columns
        ):
            if self.coverage_norm in ("cov_cis_raw", "cov_tot_raw"):
                coverage_mod.coverage(
                    self.clr, store=True, ignore_diags=self.ignore_diags
                )
            else:
                raise ValueError(
                    f"coverage_norm {self.coverage_norm} not found in cooler bins"
                )

        if self.rescale:
            if self.rescale_flank is None:
                raise ValueError("Cannot use rescale without setting rescale_flank")
            if self.rescale_size % 2 == 0:
                raise ValueError("Please provide an odd rescale_size")
            iv = self.CC.intervals
            if self.CC.kind == "bed":
                self.max_extent_bins = int(
                    (iv["endBin"] - iv["stBin"]).max()
                )
            else:
                self.max_extent_bins = int(
                    max(
                        (iv["endBin1"] - iv["stBin1"]).max(),
                        (iv["endBin2"] - iv["stBin2"]).max(),
                    )
                )

        self.empty_outmap = self.make_outmap()

    # ------------------------------------------------------------------

    def make_outmap(self):
        if self.rescale:
            return np.zeros((self.rescale_size, self.rescale_size))
        return np.zeros((2 * self.pad_bins + 1, 2 * self.pad_bins + 1))

    def get_expected_trans(self, region1, region2):
        exp_value = self.expected_df.loc[
            (self.expected_df["region1"] == region1)
            & (self.expected_df["region2"] == region2),
            self.expected_value_col,
        ]
        return float(exp_value.iloc[0])

    # -- device plumbing ----------------------------------------------------

    def _region_device_inputs(self, region1, region2, minpad=512):
        """Fetch + stage everything per region pair that snips index into."""
        r1c = self.view_df.loc[region1]
        r2c = self.view_df.loc[region2] if region2 != region1 else r1c
        min1, max1 = self.view_df_extents[region1]
        min2, max2 = self.view_df_extents[region2]
        n1, n2 = max1 - min1, max2 - min2

        slab = self.clr.fetch_slab(r1c, r2c, balance=self.clr_weight_name)

        def padded(vec, fill=0.0):
            out = np.full(
                _next_pow2(len(vec) + minpad), fill, dtype=np.float32
            )
            out[: len(vec)] = vec
            return out

        valid1 = padded(
            (~self.clr.bad_bin_mask(r1c, self.clr_weight_name)).astype(np.float32)
        )
        valid2 = padded(
            (~self.clr.bad_bin_mask(r2c, self.clr_weight_name)).astype(np.float32)
        )
        if self.coverage_norm:
            cov1 = padded(
                self.clr.bins()[self.coverage_norm].fetch(r1c).values
            )
            cov2 = padded(
                self.clr.bins()[self.coverage_norm].fetch(r2c).values
            )
        else:
            cov1 = np.zeros(8, np.float32)
            cov2 = np.zeros(8, np.float32)

        if self.expected:
            if self.trans:
                evec = np.array(
                    [self.get_expected_trans(region1, region2)], np.float32
                )
            else:
                evec = padded(self.expected_vectors[region1], fill=np.nan)
        else:
            evec = np.array([np.nan], np.float32)

        return dict(
            slab=slab,
            min1=min1,
            min2=min2,
            n1=n1,
            n2=n2,
            valid1=valid1,
            valid2=valid2,
            cov1=cov1,
            cov2=cov2,
            evec=evec,
            cis=(not self.trans) and (region1 == region2),
        )

    def _tile_f16_mode(self):
        """Wire-compression policy for raw tile uploads (see
        ops/tiles.cast_tiles_f16): balanced matrices carry O(1) values
        where scaled f16's <=4.9e-4 relative error is below the noise of
        any pile-up average ("lossy"); unbalanced matrices carry integer
        counts, shipped f16 only when the cast round-trips bit-exactly
        ("exact" — always true for counts <= 2048, verified otherwise).
        CPU runs keep f32 so the frozen goldens stay exact; on accelerators
        the wire compression is on by default."""
        if not bool(getattr(self, "tile_f16", True)):
            return False
        if not self._on_accelerator():
            return False
        return "lossy" if self.clr_weight_name else "exact"

    def _window_bins(self):
        """Window size in bins for the non-rescaled path (reference
        make_outmap, coolpup.py:1007–1022)."""
        return 2 * self.pad_bins + 1

    def _build_rescale_stack(self, dev, B, **kw):
        """Base tile stack of the rescale restack: cis regions take the
        upper-triangle build (half the scatter and half the upload; the
        device mirrors the lower tiles — ops/tiles.SymTileStack)."""
        slab = dev["slab"]
        if dev["cis"] and getattr(slab, "mirror", False):
            return build_tile_stack_slab_sym(slab, B, **kw)
        return build_tile_stack_slab(slab, B, **kw)

    def _on_accelerator(self):
        import jax

        return jax.devices()[0].platform != "cpu"

    def _stage_region(self, region1, region2):
        """Fetch + stage one region pair's device inputs (prefetchable)."""
        timers = self._timers
        ctx = timers.phase("ingest") if timers else contextlib.nullcontext()
        with ctx:
            if self.rescale:
                # per-bin vectors must cover the LARGEST extent bucket's
                # window slices: the device restack floors buckets at 128
                # (B0), so Hmax alone under-padded small regions (slice
                # overrun on toy-sized views)
                Hmax = max(128, _next_pow2(self.max_extent_bins))
                return self._region_device_inputs(
                    region1, region2, minpad=Hmax + 8
                )
            return self._region_device_inputs(region1, region2)

    def pileup_region(
        self,
        region1,
        region2=None,
        groupby=None,
        modify_2Dintervals_func=None,
        postprocess_frame_func=None,
        postprocess_snip_func=None,
        postprocess_batch_func=None,
        extra_sum_funcs=None,
        dev=None,
        dual_anchor=False,
        column_hint=None,
    ):
        """Accumulate all snips of one region (pair) on device; returns
        {"ROI": {group: pup}, "control": {...}} (reference
        coolpup.py:1285-1358).

        Two phases: (1) host streams vectorized snip frames into flat index
        arrays (bounds-checked, group ids factorized); (2) one block-sparse
        tile stack is built for the whole region and staged on device once,
        then the snips run through the fused device step.

        Hooks that need per-snip data (postprocess_snip_func) or per-snip
        extra accumulators (extra_sum_funcs) route through the host snip
        stream instead (reference accumulate_stream, coolpup.py:1236–1283)."""
        groupby = groupby or []
        if region2 is None:
            region2 = region1

        if postprocess_batch_func is not None:
            if postprocess_snip_func is not None:
                raise ValueError(
                    "postprocess_batch_func and postprocess_snip_func "
                    "are mutually exclusive"
                )
            if (
                self.rescale
                or self.store_stripes
                or (self.expected and not self.ooe)
                or self.mesh is not None
                or dual_anchor
            ):
                raise ValueError(
                    "postprocess_batch_func does not support rescale / "
                    "stripes / expected-emission / mesh / by-window "
                    "runs; use postprocess_snip_func there"
                )
            return self._pileup_region_batchhook(
                region1,
                region2,
                groupby,
                modify_2Dintervals_func,
                postprocess_frame_func,
                postprocess_batch_func,
                extra_sum_funcs,
                dev=dev,
            )

        if dev is None:
            dev = self._stage_region(region1, region2)

        # extra_sum_funcs in the canonical accumulate_values form stay on
        # the device kernel: the values are frame columns, grouped per cid
        # on the host with zero per-snip work. Opaque hooks,
        # per-snip data hooks, and expected-emission runs (whose synthetic
        # exp snips must also flow through the hooks) use the host stream.
        extra_frame_keys = None
        if (
            extra_sum_funcs
            and postprocess_snip_func is None
            and not (self.expected and not self.ooe)
        ):
            extra_frame_keys = _accumulate_values_frame_keys(extra_sum_funcs)
        if postprocess_snip_func is not None or (
            extra_sum_funcs and extra_frame_keys is None
        ):
            if not getattr(self, "_warned_hostpath", False):
                self._warned_hostpath = True
                logger.warning(
                    "per-snip extension hooks (postprocess_snip_func / "
                    "opaque extra_sum_funcs) run on the HOST snip stream — "
                    "expect ~10-50k snips/s instead of the device kernel's "
                    "millions; accumulate_values-style extra_sum_funcs over "
                    "frame columns and postprocess_frame_func stay on the "
                    "device path"
                )
            return self._pileup_region_hostpath(
                region1,
                region2,
                groupby,
                modify_2Dintervals_func,
                postprocess_frame_func,
                postprocess_snip_func,
                extra_sum_funcs,
                dev=dev,
            )
        if self.rescale:
            R = self.rescale_size
            Hmax = _next_pow2(self.max_extent_bins)
            B = max(64, Hmax)
        else:
            W = self._window_bins()
            B = max(64, _next_pow2(W))
        shape = self.make_outmap().shape

        emit_expected = bool(self.expected and not self.ooe)
        use_expected = bool(self.expected)
        coverage = bool(self.coverage_norm)

        cid_of = {}

        def ensure_cid(kind, group):
            key = (kind, group)
            if key not in cid_of:
                cid_of[key] = len(cid_of)
            return cid_of[key]

        region1_coords = tuple(self.view_df.loc[region1])
        region2_coords = tuple(self.view_df.loc[region2])

        timers = self._timers

        # -- phase 1: host coordinate collection -----------------------
        cols = {k: [] for k in ("r1", "r2", "dd0", "cidl", "flip", "h1", "w2")}
        if self.store_stripes:
            cols["roi"] = []
        coord_blocks = []
        dual_lut = None
        extra_cols = (
            {k: [] for k in extra_frame_keys} if extra_frame_keys else None
        )
        if column_hint is not None:
            # extend the engine's fast-path column hint with what THIS
            # region's features need; None (user hooks present) keeps all
            column_hint = set(column_hint)
            if extra_frame_keys:
                column_hint |= set(extra_frame_keys.values())
            if self.store_stripes:
                column_hint |= {
                    "chrom1", "start1", "end1",
                    "chrom2", "start2", "end2",
                }
            if dual_anchor:
                column_hint |= {"anchor_idx1", "anchor_idx2"}
        for chunk in self.CC.batches(
            region1_coords,
            region2_coords if region2 != region1 else None,
            control=self.control,
            groupby=groupby,
            modify_2Dintervals_func=modify_2Dintervals_func,
            columns=(
                tuple(sorted(column_hint))
                if column_hint is not None
                else None
            ),
        ):
            if postprocess_frame_func is not None:
                chunk = postprocess_frame_func(chunk)
            if len(chunk) == 0:
                continue
            if extra_frame_keys is not None:
                missing = [
                    c
                    for c in extra_frame_keys.values()
                    if c not in chunk.columns
                ]
                if missing:
                    # value only exists per-snip (not a frame column):
                    # fall back to the host stream. Safe mid-loop: this
                    # fires on the FIRST non-empty chunk, before anything
                    # was collected or streamed.
                    assert not any(cols["r1"]), missing
                    logger.warning(
                        "extra_sum_funcs keys %s are not feature-frame "
                        "columns; falling back to the host snip stream",
                        missing,
                    )
                    return self._pileup_region_hostpath(
                        region1, region2, groupby,
                        modify_2Dintervals_func, postprocess_frame_func,
                        postprocess_snip_func, extra_sum_funcs, dev=dev,
                    )
            r1 = chunk["stBin1"].values - dev["min1"]
            r2 = chunk["stBin2"].values - dev["min2"]
            e1 = chunk["endBin1"].values - dev["min1"]
            e2 = chunk["endBin2"].values - dev["min2"]
            inb = (r1 >= 0) & (e1 <= dev["n1"]) & (r2 >= 0) & (e2 <= dev["n2"])
            chunk = chunk.loc[inb]
            if len(chunk) == 0:
                continue
            if dual_anchor:
                # by-window: each snip contributes to BOTH anchors' groups.
                # Duplicating the flat arrays replaces the frame-doubling
                # postprocess (pandas copies of 14M rows dominated
                # by-window walls); groups are (kind, anchor_idx) ints via
                # a dense lookup
                n_c = len(chunk)
                r1c = (chunk["stBin1"].values - dev["min1"]).astype(
                    np.int32
                )
                r2c = (chunk["stBin2"].values - dev["min2"]).astype(
                    np.int32
                )
                dd0c = (
                    chunk["stBin1"].values - chunk["stBin2"].values
                ).astype(np.int32)
                h1c = (
                    chunk["endBin1"].values - chunk["stBin1"].values
                ).astype(np.int32)
                w2c = (
                    chunk["endBin2"].values - chunk["stBin2"].values
                ).astype(np.int32)
                if not self.rescale:
                    assert (h1c == W).all() and (w2c == W).all()
                a1 = chunk["anchor_idx1"].to_numpy().astype(np.int64)
                a2 = chunk["anchor_idx2"].to_numpy().astype(np.int64)
                isctl = (
                    chunk["kind"].to_numpy() == "control"
                ).astype(np.int8)
                if dual_lut is None:
                    dual_lut = np.full(
                        (2, len(self.CC.intervals)), -1, np.int32
                    )
                lut = dual_lut
                for ids in (a1, a2):
                    for k, kname in ((0, "ROI"), (1, "control")):
                        sel = ids[isctl == k]
                        fresh = np.unique(sel[lut[k, sel] < 0])
                        for u in fresh:
                            lut[k, u] = ensure_cid(kname, int(u))
                cid1 = lut[isctl, a1].astype(np.int32)
                cid2 = lut[isctl, a2].astype(np.int32)
                if "flip" in chunk.columns:
                    # flip_negative_strand marks ride through to the
                    # flip-bank accumulation like every other mode
                    flip_c = chunk["flip"].values.astype(bool)
                else:
                    flip_c = np.zeros(n_c, bool)
                cols["r1"] += [r1c, r1c]
                cols["r2"] += [r2c, r2c]
                cols["dd0"] += [dd0c, dd0c]
                cols["flip"] += [flip_c, flip_c]
                cols["cidl"] += [cid1, cid2]
                cols["h1"] += [h1c, h1c]
                cols["w2"] += [w2c, w2c]
                if self.store_stripes:
                    roi_c = isctl == 0
                    cols["roi"] += [roi_c, roi_c]
                    blk = tuple(
                        chunk[c].to_numpy()[roi_c]
                        for c in (
                            "chrom1", "start1", "end1",
                            "chrom2", "start2", "end2",
                        )
                    )
                    coord_blocks += [blk, blk]
                continue
            if extra_cols is not None:
                for outkey, col in extra_frame_keys.items():
                    extra_cols[outkey].append(chunk[col].values)
            h1 = (chunk["endBin1"].values - chunk["stBin1"].values).astype(
                np.int32
            )
            w2 = (chunk["endBin2"].values - chunk["stBin2"].values).astype(
                np.int32
            )
            if not self.rescale:
                assert (h1 == W).all() and (w2 == W).all(), (
                    "inconsistent window size; flank must be a multiple of "
                    "the resolution"
                )
            cols["r1"].append(
                (chunk["stBin1"].values - dev["min1"]).astype(np.int32)
            )
            cols["r2"].append(
                (chunk["stBin2"].values - dev["min2"]).astype(np.int32)
            )
            cols["dd0"].append(
                (chunk["stBin1"].values - chunk["stBin2"].values).astype(
                    np.int32
                )
            )
            if "flip" in chunk.columns:
                cols["flip"].append(chunk["flip"].values.astype(bool))
            else:
                cols["flip"].append(np.zeros(len(chunk), bool))
            # vectorized (kind, group) -> cid: python only per UNIQUE pair.
            # Categorical columns (kind always; group via assign_groups)
            # expose their codes directly — re-factorizing object columns
            # per chunk cost ~0.1 us/row across millions of rows.
            # use_na_sentinel=False keeps a NaN group as a regular category
            # (the -1 sentinel would alias a legitimate (kind, group) code)
            def _codes(col):
                if isinstance(col.dtype, pd.CategoricalDtype):
                    codes = col.cat.codes.to_numpy()
                    if not (codes < 0).any():
                        # -1 marks NaN entries; those must go through the
                        # factorize path so NaN stays a real category
                        return codes, col.cat.categories
                return pd.factorize(col, use_na_sentinel=False)

            kcode, kuniq = _codes(chunk["kind"])
            gcode, guniq = _codes(chunk["group"])
            ng = max(len(guniq), 1)
            pair = kcode.astype(np.int64) * ng + gcode
            upair, first_idx, inv = np.unique(
                pair, return_index=True, return_inverse=True
            )
            # assign cids in FIRST-APPEARANCE order: cid_of insertion
            # order defines group order downstream (the 'all' reduce and
            # extras concatenation must match the host stream's order;
            # categorical codes alone would impose category order)
            for p in upair[np.argsort(first_idx)]:
                ensure_cid(kuniq[p // ng], guniq[p % ng])
            ucid = np.array(
                [
                    cid_of[(kuniq[p // ng], guniq[p % ng])]
                    for p in upair
                ],
                dtype=np.int32,
            )
            cols["cidl"].append(ucid[inv])
            cols["h1"].append(h1)
            cols["w2"].append(w2)
            if self.store_stripes:
                # stripe planes + coordinates only exist for ROI snips:
                # control planes/coords never reach the output (reference
                # coolpup.py:1533–1625), and at nshifts=10 they would be
                # 10x the transfer volume of the real data
                roi = chunk["kind"].to_numpy() == "ROI"
                cols["roi"].append(roi)
            if self.store_stripes:
                # keep RAW column arrays here (one cheap .to_numpy per
                # column); the string casts happen once per region over the
                # concatenated columns below — per-chunk U-casts sat on the
                # host critical path of stripe runs
                coord_blocks.append(
                    tuple(
                        chunk[c].to_numpy()[roi]
                        for c in (
                            "chrom1", "start1", "end1",
                            "chrom2", "start2", "end2",
                        )
                    )
                )

        ntot = sum(len(a) for a in cols["r1"])
        acc = {}
        n_counts = {}
        stripes = {}
        extras = {}

        if ntot > 0:
            arr = {k: np.concatenate(v) for k, v in cols.items()}
            if timers:
                timers.count("snips", ntot)

            G = len(cid_of)
            Chalf = max(4, _next_pow2(G))
            C = 2 * Chalf
            cid_dev = (arr["cidl"] + Chalf * arr["flip"]).astype(np.int32)
            large_g = G > 512

            counts = np.bincount(arr["cidl"], minlength=G)
            for i, c in enumerate(counts):
                n_counts[i] = int(c)

            # -- phase 2: one tile stack, device-resident sub-chunk loop
            tile_ctx = (
                timers.phase("tiles") if timers else contextlib.nullcontext()
            )
            dev_ctx = (
                timers.phase("device") if timers else contextlib.nullcontext()
            )
            if self.rescale:
                with dev_ctx:
                    out_total = self._rescale_accumulate(
                        dev,
                        arr,
                        cid_dev,
                        ntot,
                        C,
                        use_expected,
                        emit_expected,
                        coverage,
                        large_g,
                    )
                out_total = merge_flip_banks(out_total, Chalf)
            else:
                with tile_ctx:
                    tile_stack = build_tile_stack_slab(
                        dev["slab"],
                        B,
                        r1=arr["r1"],
                        r2=arr["r2"],
                        window1=W,
                        window2=W,
                    )
                with dev_ctx:
                    out_total = self._xla_accumulate(
                        tile_stack, dev, arr, cid_dev, ntot, C, W, B,
                        use_expected, emit_expected, coverage, large_g,
                    )
                    out_total = merge_flip_banks(out_total, Chalf)
            for k, v in out_total.items():
                if k in ("horizontal_stripe", "vertical_stripe"):
                    continue
                acc[k] = v

            if self.store_stripes:
                # each group keeps ONE 2D block per region instead of a
                # python list of millions of row arrays. Planes/coords exist
                # only for ROI snips; the device step emits full-stream
                # planes, filtered here
                roi_all = arr["roi"]
                hs = np.asarray(out_total["horizontal_stripe"])[roi_all]
                vs = np.asarray(out_total["vertical_stripe"])[roi_all]
                cid_roi = arr["cidl"][roi_all]
                order_roi = np.argsort(cid_roi, kind="stable")
                bounds_roi = np.searchsorted(
                    cid_roi[order_roi], np.arange(len(cid_of) + 1)
                )
                # one vectorized string cast per column per region (numpy
                # U-cast is ~5x pandas astype(str) at millions of rows)
                cols6 = []
                for ci in range(6):
                    col = np.concatenate(
                        [blk[ci] for blk in coord_blocks]
                    )
                    if col.dtype.kind in "iu":
                        col = col.astype("U20").astype(object)
                    elif col.dtype.kind != "O":
                        col = col.astype(str).astype(object)
                    cols6.append(col)
                coords_arr = np.stack(cols6, axis=1)
                for c in range(len(cid_of)):
                    sel = order_roi[bounds_roi[c] : bounds_roi[c + 1]]
                    if len(sel) == 0:
                        continue
                    stripes[c] = {
                        "h": [hs[sel]],
                        "v": [vs[sel]],
                        "coords": [coords_arr[sel]],
                    }
            if extra_cols is not None:
                order = np.argsort(arr["cidl"], kind="stable")
                bounds = np.searchsorted(
                    arr["cidl"][order], np.arange(len(cid_of) + 1)
                )
                # accumulate_values semantics: a flat per-group list of the
                # frame-column values in stream order, stored under the
                # SNIP key like the host stream's _add_snip (the reference
                # convention is output key == snip key,
                # puputils.py:244–253)
                for outkey, col in extra_frame_keys.items():
                    vals = np.concatenate(extra_cols[outkey])
                    extras[col] = {
                        c: vals[order[bounds[c] : bounds[c + 1]]].tolist()
                        for c in range(len(cid_of))
                        if bounds[c + 1] > bounds[c]
                    }

        # -- package into pup dicts ------------------------------------
        outdict = {"ROI": {}, "control": {}}
        for (kind, group), i in cid_of.items():
            if n_counts.get(i, 0) == 0:
                continue
            pup = {
                "data": acc["sum"][i],
                "num": acc["num"][i],
                "poison": acc["poison"][i],
                "n": n_counts[i],
                "cov_start": acc["cov_start"][i]
                if self.coverage_norm
                else np.zeros(shape[0]),
                "cov_end": acc["cov_end"][i]
                if self.coverage_norm
                else np.zeros(shape[1]),
                "horizontal_stripe": stripes.get(i, {}).get("h", []),
                "vertical_stripe": stripes.get(i, {}).get("v", []),
                "coordinates": stripes.get(i, {}).get("coords", []),
            }
            for outkey in extras:
                pup[outkey] = extras[outkey].get(i, [])
            if isinstance(group, (str, int, np.integer)):
                key = group
            else:
                key = tuple(group)
            outdict[kind][key] = pup
            if emit_expected and kind == "ROI":
                epup = {
                    "data": acc["exp_sum"][i],
                    "num": acc["exp_num"][i],
                    "poison": np.zeros(shape),
                    "n": n_counts[i],
                    "cov_start": np.zeros(shape[0]),
                    "cov_end": np.zeros(shape[1]),
                    "horizontal_stripe": [],
                    "vertical_stripe": [],
                    "coordinates": [],
                }
                if key in outdict["control"]:
                    outdict["control"][key] = dict(
                        sum_pups(outdict["control"][key], epup)
                    )
                else:
                    outdict["control"][key] = epup

        sum_func = (
            partial(sum_pups, extra_funcs=extra_sum_funcs)
            if extra_frame_keys
            else sum_pups
        )

        def _fast_all(pups_iter):
            """Vectorized 'all' reduction: reduce(sum_pups) builds a
            pd.Series per merge, which at by-window's tens of thousands of
            groups cost seconds; summing the stacked planes is exact
            (same nan_to_num + concat semantics as sum_pups)."""
            pups_list = list(pups_iter)
            out = {
                "data": np.nan_to_num(
                    np.sum([p["data"] for p in pups_list], axis=0)
                ),
                "num": np.sum([p["num"] for p in pups_list], axis=0),
                "poison": np.sum(
                    [p["poison"] for p in pups_list], axis=0
                ),
                "n": int(sum(p["n"] for p in pups_list)),
                "cov_start": np.sum(
                    [p["cov_start"] for p in pups_list], axis=0
                ),
                "cov_end": np.sum(
                    [p["cov_end"] for p in pups_list], axis=0
                ),
                "horizontal_stripe": [
                    s for p in pups_list for s in p["horizontal_stripe"]
                ],
                "vertical_stripe": [
                    s for p in pups_list for s in p["vertical_stripe"]
                ],
                "coordinates": [
                    c for p in pups_list for c in p["coordinates"]
                ],
            }
            return out

        if "all" not in outdict["ROI"] and len(outdict["ROI"]) > 64 and (
            not extra_frame_keys
        ):
            outdict["ROI"]["all"] = _fast_all(outdict["ROI"].values())
        if (
            (self.control or emit_expected)
            and "all" not in outdict["control"]
            and len(outdict["control"]) > 64
            and not extra_frame_keys
        ):
            outdict["control"]["all"] = _fast_all(
                outdict["control"].values()
            )
        if "all" not in outdict["ROI"]:
            outdict["ROI"]["all"] = dict(
                reduce(sum_func, outdict["ROI"].values(), empty_pup(shape))
            )
        if self.control or emit_expected:
            if "all" not in outdict["control"]:
                outdict["control"]["all"] = dict(
                    reduce(sum_func, outdict["control"].values(), empty_pup(shape))
                )
        if outdict["ROI"]["all"]["n"] > 0:
            logger.info(f"{region1, region2}: {outdict['ROI']['all']['n']}")
        return outdict

    def _xla_accumulate(
        self, tile_stack, dev, arr, cid_dev, ntot, C, W, B, use_expected,
        emit_expected, coverage, large_g,
    ):
        """The fused XLA step: row-banded tiles with a ppermute halo under
        a mesh that can band the region, the chunk loop otherwise."""
        out = None
        if self.mesh is not None and dict(self.mesh.shape).get("loci", 1) > 1:
            # each device's memory holds only its tile-row band
            out = self._rowshard_accumulate(
                tile_stack, dev, arr, cid_dev, ntot, C, W, B, use_expected,
                emit_expected, coverage, large_g,
            )
        if out is None:
            out = self._device_accumulate(
                tile_stack, dev, arr, cid_dev, ntot,
                self._chunk_size_for(ntot), C, W, B, use_expected,
                emit_expected, coverage, large_g,
            )
        return out

    def _chunk_size_for(self, ntot, rescale=False):
        """Fixed pow2 device chunk size (bounded working set, one compiled
        shape per size), rounded to equal per-device shards under a mesh."""
        if rescale:
            S_sub = min(4096, max(64, _next_pow2(ntot)))
        else:
            S_sub = min(65536, max(256, _next_pow2(ntot)))
        if self.mesh is not None:
            n_shards = int(self.mesh.shape["loci"])
            S_sub = _next_pow2(-(-S_sub // n_shards)) * n_shards
        return S_sub

    def _rescale_accumulate(
        self,
        dev,
        arr,
        cid_dev,
        ntot,
        C,
        use_expected,
        emit_expected,
        coverage,
        large_g,
    ):
        """Variable-extent snips bucketed by pow2 extent: each bucket gets its
        own tile stack (tile size = bucket extent) and rescale step
        (Hmax = bucket extent), so gather traffic and resize matmuls scale
        with the snips' actual sizes instead of the global maximum — one
        oversized TAD no longer forces giant superwindows on every snip."""
        import contextlib as _ctx

        import jax

        from ..ops.gather import pad_pow2
        from ..ops.tiles import make_restack, restack_indices

        timers = self._timers
        # single-device path: scatter the region's pixels ONCE into a B=128
        # base stack, upload it once, and build each extent bucket's big
        # tiles ON DEVICE as an m×m mosaic take (restack_indices/
        # make_restack) instead of re-scattering and re-uploading raw
        # [K, hb, hb] stacks per bucket
        use_restack = self.mesh is None
        B0 = 128
        ts128 = None
        tiles128_dev = None
        if use_restack:
            tctx = timers.phase("tiles") if timers else _ctx.nullcontext()
            with tctx:
                ts128 = self._build_rescale_stack(
                    dev, B0,
                    r1=arr["r1"], r2=arr["r2"],
                    window1=arr["h1"], window2=arr["w2"],
                )
            if hasattr(ts128, "upper"):
                # upper-triangle build: half the scatter + upload; the full
                # raw stack materializes on device (ops/tiles.SymTileStack)
                from ..ops.tiles import expand_sym_device

                tiles128_dev = expand_sym_device(
                    ts128,
                    k_pad=_next_pow2(ts128.n_tiles + 1),
                    f16_mode=self._tile_f16_mode(),
                )
            else:
                tiles128_dev = jax.device_put(
                    pad_pow2(ts128.tiles, axis=0)
                )

        extent = np.maximum(arr["h1"], arr["w2"]).astype(np.int64)
        min_bucket = B0 if use_restack else 64
        buckets = np.maximum(
            min_bucket,
            1 << np.ceil(np.log2(np.maximum(extent, 1))).astype(np.int64),
        )
        total = None
        stripes_h = stripes_v = None
        for hb in np.unique(buckets):
            idx = np.nonzero(buckets == hb)[0]
            sub = {k: arr[k][idx] for k in ("r1", "r2", "dd0", "h1", "w2")}
            staged = None
            ts = None
            if use_restack:
                tile_map_b, ridx = restack_indices(
                    ts128, int(hb), sub["r1"], sub["r2"],
                    sub["h1"], sub["w2"],
                )
                tiles_b = make_restack(int(hb) // B0, B0)(
                    tiles128_dev, pad_pow2(ridx, axis=0)
                )
                staged = (
                    tiles_b,
                    jax.device_put(pad_pow2(tile_map_b.ravel())),
                    np.int32(tile_map_b.shape[1]),
                )
            else:
                tctx = (
                    timers.phase("tiles") if timers else _ctx.nullcontext()
                )
                with tctx:
                    ts = build_tile_stack_slab(
                        dev["slab"],
                        int(hb),
                        r1=sub["r1"],
                        r2=sub["r2"],
                        window1=sub["h1"],
                        window2=sub["w2"],
                    )
            if self.mesh is None and self._on_accelerator():
                # three chunk shapes per extent bucket, ever: each (Hmax, S)
                # combination is a fresh XLA compile (cached persistently
                # afterwards). The middle tier matters: typical buckets hold a few
                # hundred snips, and padding those to 4096 made the gather
                # traffic ~10x the real work
                if len(idx) <= 256:
                    S_sub = 256
                elif len(idx) <= 1024:
                    S_sub = 1024
                else:
                    S_sub = 4096
            else:
                S_sub = self._chunk_size_for(len(idx), rescale=True)
            out = self._device_accumulate(
                ts,
                dev,
                sub,
                cid_dev[idx],
                len(idx),
                S_sub,
                C,
                None,
                int(hb),
                use_expected,
                emit_expected,
                coverage,
                large_g,
                hmax=int(hb),
                staged=staged,
            )
            if self.store_stripes:
                h = out.pop("horizontal_stripe")
                v = out.pop("vertical_stripe")
                if stripes_h is None:
                    stripes_h = np.zeros((ntot, h.shape[1]))
                    stripes_v = np.zeros((ntot, v.shape[1]))
                stripes_h[idx] = h
                stripes_v[idx] = v
            total = (
                out if total is None else {k: total[k] + out[k] for k in out}
            )
        if self.store_stripes:
            total["horizontal_stripe"] = stripes_h
            total["vertical_stripe"] = stripes_v
        return total

    def _rowshard_accumulate(
        self,
        tile_stack,
        dev,
        arr,
        cid_dev,
        ntot,
        C,
        W,
        B,
        use_expected,
        emit_expected,
        coverage,
        large_g,
    ):
        """Row-partitioned mesh execution (parallel/rowshard.py): the region's
        tile stack is split into per-device tile-row bands, snips route to the
        device owning their start row, and the one boundary tile-row a window
        can straddle moves between neighbors via an in-program ppermute halo
        exchange — per-device matrix memory is O(region / n_devices), the
        multi-device analog of the reference's whole-CSR-per-worker memory
        model (reference coolpup.py:1053–1077). Returns None when the region
        is too small to band (fewer tile rows than devices); the caller falls
        back to replicated tiles."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec

        from ..parallel.rowshard import (
            build_row_partition,
            make_row_sharded_step,
            route_snips,
        )

        n = int(dict(self.mesh.shape)["loci"])
        part = build_row_partition(tile_stack, arr["r1"], n)
        if part is None:
            # region too small to band: replicated-tiles fallback. Track the
            # rate so the memory win stays observable.
            self._rowshard_fallbacks = (
                getattr(self, "_rowshard_fallbacks", 0) + 1
            )
            logger.info(
                "rowshard: region too small to band over %d devices, "
                "replicating tiles (fallback %d so far)",
                n,
                self._rowshard_fallbacks,
            )
            return None
        order, counts = route_snips(part, arr["r1"])
        maxcnt = int(counts.max())
        # every device pads its shard to the busiest band's pow2 count; under
        # heavy feature clustering the other devices would run mostly-masked
        # gathers each chunk — the replicated path splits evenly and wins
        if maxcnt > 4 * max(1.0, float(counts.mean())):
            self._rowshard_fallbacks = (
                getattr(self, "_rowshard_fallbacks", 0) + 1
            )
            logger.info(
                "rowshard: snip load skew %.1fx across bands, falling back "
                "to replicated tiles",
                maxcnt / max(1.0, float(counts.mean())),
            )
            return None
        self._rowshard_regions = getattr(self, "_rowshard_regions", 0) + 1
        S_dev = min(16384, max(256, _next_pow2(maxcnt)))
        cfg = GatherConfig(
            W=W,
            B=B,
            S=S_dev,
            block=min(512, S_dev),
            capacity=C,
            cis=dev["cis"],
            ignore_diags=int(self.ignore_diags),
            ooe=bool(use_expected and self.ooe),
            emit_expected=emit_expected,
            coverage=coverage,
            stripes=bool(self.store_stripes),
            large_g=large_g,
        )
        step = make_row_sharded_step(cfg, self.mesh)

        shard = NamedSharding(self.mesh, PartitionSpec("loci"))
        rep = NamedSharding(self.mesh, PartitionSpec())
        tiles_dev = jax.device_put(part.tiles, shard)
        send_dev = jax.device_put(part.send_idx, shard)
        tmap_dev = jax.device_put(part.tile_map, shard)
        common = tuple(
            jax.device_put(x, rep)
            for x in (
                dev["evec"],
                dev["valid1"],
                dev["valid2"],
                dev["cov1"],
                dev["cov2"],
            )
        )

        dev_items = np.split(order, np.cumsum(counts)[:-1])
        total = None
        stripes_h = stripes_v = None
        if self.store_stripes:
            stripes_h = np.full((ntot, W), np.nan)
            stripes_v = np.full((ntot, W), np.nan)
        for c in range(-(-maxcnt // S_dev)):
            r1c = np.zeros((n, S_dev), arr["r1"].dtype)
            r2c = np.zeros((n, S_dev), arr["r2"].dtype)
            dd0c = np.zeros((n, S_dev), arr["dd0"].dtype)
            cidc = np.zeros((n, S_dev), cid_dev.dtype)
            smc = np.zeros((n, S_dev), bool)
            sels = []
            for d in range(n):
                sel = dev_items[d][c * S_dev : (c + 1) * S_dev]
                sels.append(sel)
                m = len(sel)
                if m:
                    r1c[d, :m] = arr["r1"][sel]
                    r2c[d, :m] = arr["r2"][sel]
                    dd0c[d, :m] = arr["dd0"][sel]
                    cidc[d, :m] = cid_dev[sel]
                    smc[d, :m] = True
            out = step(
                tiles_dev, send_dev, tmap_dev, part.ncolp, *common,
                r1c, r2c, dd0c, cidc, smc,
            )
            if self.store_stripes:
                h = np.asarray(out.pop("horizontal_stripe"), np.float64)
                v = np.asarray(out.pop("vertical_stripe"), np.float64)
                for d, sel in enumerate(sels):
                    if len(sel):
                        stripes_h[sel] = h[d * S_dev : d * S_dev + len(sel)]
                        stripes_v[sel] = v[d * S_dev : d * S_dev + len(sel)]
            total = (
                out if total is None else jax.tree.map(jnp.add, total, out)
            )
        if total is None:
            return None
        total = {k: np.asarray(v, np.float64) for k, v in total.items()}
        if self.store_stripes:
            total["horizontal_stripe"] = stripes_h
            total["vertical_stripe"] = stripes_v
        return total

    def _device_accumulate(
        self,
        tile_stack,
        dev,
        arr,
        cid_dev,
        ntot,
        S_sub,
        C,
        W,
        B,
        use_expected,
        emit_expected,
        coverage,
        large_g,
        hmax=None,
        staged=None,
    ):
        """The fused step's chunk loop: stage the tile stack once,
        loop fixed-size sub-chunks through the fused step, keeping a running
        on-device total (one accumulator set live regardless of chunk count;
        dispatches stay async so chunks still pipeline). Stripe planes are
        per-snip output data and are retained per chunk (device-side) until
        the single sync. ``staged`` = (tiles_dev, tmap_dev, ncolp) supplies
        already-device-resident tiles (the rescale bucket restack) and skips
        the host upload entirely."""
        import jax
        import jax.numpy as jnp

        total = None
        stripe_h, stripe_v = [], []

        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            replicated = NamedSharding(self.mesh, PartitionSpec())

            def put(x):
                return jax.device_put(x, replicated)

        else:
            put = jax.device_put
        # pow2-pad the stack depth and tile-map length: both ride the jitted
        # step's input signature, and raw sizes would retrace per region
        from ..ops.gather import pad_pow2

        if staged is not None:
            tiles_dev, tmap_dev, ncolp = staged
        else:
            tiles_dev = put(pad_pow2(tile_stack.tiles, axis=0))
            tmap_dev = put(pad_pow2(tile_stack.tile_map.ravel()))
            ncolp = np.int32(tile_stack.tile_map.shape[1])
        common = tuple(
            put(x)
            for x in (
                dev["evec"],
                dev["valid1"],
                dev["valid2"],
                dev["cov1"],
                dev["cov2"],
            )
        )

        rescale = hmax is not None
        # under a mesh the step is compiled for the PER-DEVICE shard size and
        # shard_mapped over "loci"; inputs stay global [S_sub] arrays
        n_shards = int(self.mesh.shape["loci"]) if self.mesh is not None else 1
        S_dev = S_sub // n_shards
        for lo in range(0, ntot, S_sub):
            sl = slice(lo, min(lo + S_sub, ntot))
            S = sl.stop - sl.start

            def pad(a, fill=0):
                out = np.full(S_sub, fill, a.dtype)
                out[:S] = a[sl]
                return out

            snipmask = np.zeros(S_sub, bool)
            snipmask[:S] = True
            if rescale:
                # block shrinks with extent: per-block superwindow memory is
                # block × (2·Hmax)² — large-extent buckets otherwise produce
                # gigantic fused programs (compile-service failures observed)
                blk = min(64, max(8, 4096 // max(1, hmax)), S_dev)
                cfg = RescaleConfig(
                    R=self.rescale_size,
                    Hmax=hmax,
                    B=B,
                    S=S_dev,
                    block=blk,
                    capacity=C,
                    cis=dev["cis"],
                    ignore_diags=int(self.ignore_diags),
                    ooe=bool(use_expected and self.ooe),
                    emit_expected=emit_expected,
                    coverage=coverage,
                    stripes=bool(self.store_stripes),
                    local=bool(self.local),
                    large_g=large_g,
                )
                if self.mesh is not None:
                    from ..parallel.mesh import make_engine_sharded_rescale_step

                    step = make_engine_sharded_rescale_step(cfg, self.mesh)
                else:
                    step = make_rescale_step(cfg)
                out = step(
                    tiles_dev, tmap_dev, ncolp, *common,
                    pad(arr["r1"]), pad(arr["r2"]),
                    pad(arr["h1"], 1), pad(arr["w2"], 1),
                    pad(arr["dd0"]), pad(cid_dev), snipmask,
                )
            else:
                cfg = GatherConfig(
                    W=W,
                    B=B,
                    S=S_dev,
                    block=min(512, S_dev),
                    capacity=C,
                    cis=dev["cis"],
                    ignore_diags=int(self.ignore_diags),
                    ooe=bool(use_expected and self.ooe),
                    emit_expected=emit_expected,
                    coverage=coverage,
                    stripes=bool(self.store_stripes),
                    large_g=large_g,
                )
                if self.mesh is not None:
                    from ..parallel.mesh import make_engine_sharded_step

                    step = make_engine_sharded_step(cfg, self.mesh)
                else:
                    step = make_pileup_step(cfg)
                out = step(
                    tiles_dev, tmap_dev, ncolp, *common,
                    pad(arr["r1"]), pad(arr["r2"]),
                    pad(arr["dd0"]), pad(cid_dev), snipmask,
                )
            if self.store_stripes:
                stripe_h.append((out.pop("horizontal_stripe"), S))
                stripe_v.append((out.pop("vertical_stripe"), S))
            total = (
                out
                if total is None
                else jax.tree.map(jnp.add, total, out)
            )
        # single sync point: all chunk dispatches above pipeline on the device
        total = {k: np.asarray(v, np.float64) for k, v in total.items()}
        if self.store_stripes:
            total["horizontal_stripe"] = np.concatenate(
                [np.asarray(h, np.float64)[:S] for h, S in stripe_h]
            )
            total["vertical_stripe"] = np.concatenate(
                [np.asarray(v, np.float64)[:S] for v, S in stripe_v]
            )
        return total

    # -- per-snip extension surface (reference coolpup.py:1059–1283) --------

    def _rescale_snip_host(self, snip):
        """Host per-snip rescale for the extension path — reference
        _rescale_snip semantics (coolpup.py:1193–1234): local symmetrization,
        NaN-aware resize (area-average in place of the spline zoom, same
        deviation as the device path), coverage vector resize."""
        from ..ops.rescale import area_resize_host

        R = self.rescale_size
        data = np.asarray(snip["data"], dtype=float)
        if data.size == 0 or np.all(np.isnan(data)):
            snip["data"] = np.zeros((R, R))
        else:
            if self.local:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", category=RuntimeWarning)
                    data = np.nanmean(np.dstack((data, data.T)), 2)
            nanplane = np.isnan(data).astype(float)
            resized = area_resize_host(np.nan_to_num(data), (R, R))
            nan_touch = area_resize_host(nanplane, (R, R))
            resized[np.ceil(nan_touch).astype(bool)] = np.nan
            snip["data"] = resized
        if self.coverage_norm:
            snip["cov_start"] = area_resize_host(snip["cov_start"], (R,))
            snip["cov_end"] = area_resize_host(snip["cov_end"], (R,))
        else:
            snip["cov_start"] = np.zeros(R)
            snip["cov_end"] = np.zeros(R)
        return snip

    def stream_snips(
        self,
        region1,
        region2=None,
        *,
        groupby=None,
        control=None,
        modify_2Dintervals_func=None,
        postprocess_frame_func=None,
        dev=None,
    ):
        """Yield per-snip dicts with gathered ``data`` — the extension surface
        (reference _stream_snips, coolpup.py:1059–1191). Each dict carries
        every feature column plus data / cov vectors / stripes / coordinates,
        cut from the region's normalized tile stack with the exact per-pixel
        semantics of the device kernels, so per-snip hooks (e.g. the TAD
        domain-score pattern, SURVEY §3.3) see reference-identical values.
        Snips are yielded UNFLIPPED with their 'flip' mark, like the
        reference stream; expected snips (kind='control') follow their ROI
        snip when expected is used without ooe."""
        from ..ops.tiles import assemble_window, normalize_tile_stack

        groupby = groupby or []
        if control is None:
            control = self.control
        if region2 is None:
            region2 = region1
        if dev is None:
            dev = self._stage_region(region1, region2)

        if self.rescale:
            B = max(64, _next_pow2(self.max_extent_bins))
        else:
            W = self._window_bins()
            B = max(64, _next_pow2(W))
        emit_expected = bool(self.expected and not self.ooe)
        use_expected = bool(self.expected)
        evec = np.asarray(dev["evec"], dtype=float)

        region1_coords = tuple(self.view_df.loc[region1])
        region2_coords = tuple(self.view_df.loc[region2])

        for chunk in self.CC.batches(
            region1_coords,
            region2_coords if region2 != region1 else None,
            control=control,
            groupby=groupby,
            modify_2Dintervals_func=modify_2Dintervals_func,
        ):
            if postprocess_frame_func is not None:
                chunk = postprocess_frame_func(chunk)
            if len(chunk) == 0:
                continue
            r1 = (chunk["stBin1"].values - dev["min1"]).astype(np.int64)
            r2 = (chunk["stBin2"].values - dev["min2"]).astype(np.int64)
            e1 = (chunk["endBin1"].values - dev["min1"]).astype(np.int64)
            e2 = (chunk["endBin2"].values - dev["min2"]).astype(np.int64)
            inb = (r1 >= 0) & (e1 <= dev["n1"]) & (r2 >= 0) & (e2 <= dev["n2"])
            if not inb.any():
                continue
            chunk = chunk.loc[inb].reset_index(drop=True)
            r1, r2, e1, e2 = r1[inb], r2[inb], e1[inb], e2[inb]
            h1 = e1 - r1
            w2 = e2 - r2

            ts = build_tile_stack_slab(
                dev["slab"], B, r1=r1, r2=r2, window1=h1, window2=w2
            )
            stiles = normalize_tile_stack(
                ts,
                dev["valid1"],
                dev["valid2"],
                evec=dev["evec"],
                ooe=bool(use_expected and self.ooe),
                cis=dev["cis"],
                ignore_diags=int(self.ignore_diags),
            )

            # fixed-size windows: fill the whole chunk's [N, W, W] data in
            # one vectorized pass (quad-grouped superwindow gathers); each
            # snip dict then just slices its row (a per-snip np.block
            # assembly set the pace of this stream)
            data_all = None
            if not self.rescale:
                from ..ops.tiles import assemble_windows_batch

                data_all = assemble_windows_batch(
                    stiles, ts.tile_map, B, r1, r2, W
                ) if len(chunk) else None

            # lightweight record dicts: plain per-column numpy arrays +
            # one dict comprehension per snip. to_dict("records") boxes
            # every cell through pandas (maybe_box_native + Arrow
            # iteration — ~13 us/snip of the old per-snip wall); values
            # here are numpy scalars, which compare/format identically
            colnames = list(chunk.columns)
            colarrs = [
                chunk[c].to_numpy()
                if isinstance(chunk[c].dtype, np.dtype)
                else np.asarray(chunk[c].array)
                for c in colnames
            ]

            def _records():
                for i in range(len(chunk)):
                    yield {c: a[i] for c, a in zip(colnames, colarrs)}

            for i, snip in enumerate(_records()):
                a, b, h, w = int(r1[i]), int(r2[i]), int(h1[i]), int(w2[i])
                if data_all is not None:
                    snip["data"] = data_all[i]
                else:
                    # NaN-encoded stack: the cut IS the reference snip
                    # (masked -> NaN, +inf poison kept)
                    snip["data"] = assemble_window(
                        stiles, ts.tile_map, B, a, b, h, w
                    ).astype(float)

                if self.coverage_norm:
                    snip["cov_start"] = dev["cov1"][a : a + h].astype(float)
                    snip["cov_end"] = dev["cov2"][b : b + w].astype(float)
                else:
                    snip["cov_start"] = np.zeros(h)
                    snip["cov_end"] = np.zeros(w)

                exp_snip = None
                if emit_expected:
                    exp_snip = dict(snip)
                    exp_snip["kind"] = "control"
                    if len(evec) == 1:
                        exp_data = np.full((h, w), evec[0])
                    else:
                        dd = (a - b) + np.arange(h)[:, None] - np.arange(w)[None, :]
                        exp_data = evec[
                            np.minimum(np.abs(dd), len(evec) - 1)
                        ]
                    exp_snip["data"] = exp_data
                    exp_snip["coordinates"] = []

                if self.rescale:
                    snip = self._rescale_snip_host(snip)
                    if exp_snip is not None:
                        exp_snip = self._rescale_snip_host(exp_snip)

                if self.store_stripes:
                    mid = snip["data"].shape[0] // 2
                    snip["horizontal_stripe"] = np.asarray(
                        snip["data"][mid, :], dtype=float
                    )
                    snip["vertical_stripe"] = np.asarray(
                        snip["data"][:, mid][::-1], dtype=float
                    )
                    snip["coordinates"] = ".".join(
                        str(snip[col])
                        for col in (
                            "chrom1",
                            "start1",
                            "end1",
                            "chrom2",
                            "start2",
                            "end2",
                        )
                    )
                else:
                    snip["horizontal_stripe"] = []
                    snip["vertical_stripe"] = []
                    snip["coordinates"] = []
                if exp_snip is not None:
                    exp_snip["horizontal_stripe"] = []
                    exp_snip["vertical_stripe"] = []

                yield snip
                if exp_snip is not None:
                    yield exp_snip

    def _pileup_region_batchhook(
        self,
        region1,
        region2,
        groupby,
        modify_2Dintervals_func,
        postprocess_frame_func,
        postprocess_batch_func,
        extra_sum_funcs,
        dev=None,
    ):
        """Vectorized extension path: per-snip DATA semantics at batch
        speed. Each coordinate chunk's windows are filled
        host-side in one pass ([N, W, W] float32, flip applied), the user
        hook runs ONCE per chunk as ``postprocess_batch_func(frame, data)
        -> frame`` (add columns computed from ``data``; in-place edits of
        ``data`` are honored), and accumulation folds whole group slices —
        no per-snip Python at all. The TAD domain-score pattern (reference
        Walkthrough API, coolpup.py:1261–1283) writes one vectorized line
        here instead of a per-snip dict hook, at ~50-100x the throughput.

        extra_sum_funcs must be accumulate_values-style over frame
        columns (typically columns the batch hook just added); stripes /
        expected-emission / rescale are not supported here — use the
        per-snip stream (postprocess_snip_func) for those."""
        from ..ops.tiles import assemble_windows_batch, normalize_tile_stack

        groupby = groupby or []
        if region2 is None:
            region2 = region1
        if dev is None:
            dev = self._stage_region(region1, region2)
        W = self._window_bins()
        B = max(64, _next_pow2(W))
        extra_frame_keys = (
            _accumulate_values_frame_keys(extra_sum_funcs)
            if extra_sum_funcs
            else None
        )
        if extra_sum_funcs and extra_frame_keys is None:
            raise ValueError(
                "postprocess_batch_func supports accumulate_values-style "
                "extra_sum_funcs over frame columns; use "
                "postprocess_snip_func for opaque per-snip accumulators"
            )
        outdict = {"ROI": {}, "control": {}}
        region1_coords = tuple(self.view_df.loc[region1])
        region2_coords = tuple(self.view_df.loc[region2])

        from ..ops.tiles import host_pool_buf

        def _fold(key, kind, dsel, cssum, cesum, extras_rows):
            m = dsel.shape[0]
            if m == 1:
                dsum = dsel[0].astype(np.float64)  # keep NaNs (n=1 group)
                dnum = np.isfinite(dsel[0]).astype(np.int64)
            else:
                # nansum/isfinite via pooled masks + where-reduce: their
                # internal full-size copies re-pay this VM's ~50us page
                # faults on every fresh large allocation
                notnan = host_pool_buf("bh.fold1", dsel.shape, bool)
                np.isnan(dsel, out=notnan)
                np.logical_not(notnan, out=notnan)
                dsum = np.add.reduce(
                    dsel, axis=0, dtype=np.float64, where=notnan
                )
                finite = host_pool_buf("bh.fold2", dsel.shape, bool)
                np.isfinite(dsel, out=finite)
                dnum = finite.sum(axis=0)
            pup = outdict[kind].get(key)
            if pup is None:
                outdict[kind][key] = pup = {
                    "data": dsum,
                    "num": dnum,
                    "cov_start": cssum,
                    "cov_end": cesum,
                    "n": m,
                    "horizontal_stripe": [],
                    "vertical_stripe": [],
                    "coordinates": [],
                }
            else:
                pup["data"] = np.nansum([pup["data"], dsum], axis=0)
                pup["num"] = pup["num"] + dnum
                pup["cov_start"] = pup["cov_start"] + cssum
                pup["cov_end"] = pup["cov_end"] + cesum
                pup["n"] += m
            if extras_rows:
                for col, vals in extras_rows.items():
                    cur = pup.get(col)
                    if isinstance(cur, list):
                        cur.extend(vals)
                    else:
                        pup[col] = list(vals)

        from numpy.lib.stride_tricks import sliding_window_view

        for chunk in self.CC.batches(
            region1_coords,
            region2_coords if region2 != region1 else None,
            control=self.control,
            groupby=groupby,
            modify_2Dintervals_func=modify_2Dintervals_func,
        ):
            if postprocess_frame_func is not None:
                chunk = postprocess_frame_func(chunk)
            if len(chunk) == 0:
                continue
            r1 = (chunk["stBin1"].values - dev["min1"]).astype(np.int64)
            r2 = (chunk["stBin2"].values - dev["min2"]).astype(np.int64)
            e1 = (chunk["endBin1"].values - dev["min1"]).astype(np.int64)
            e2 = (chunk["endBin2"].values - dev["min2"]).astype(np.int64)
            inb = (r1 >= 0) & (e1 <= dev["n1"]) & (r2 >= 0) & (e2 <= dev["n2"])
            if not inb.any():
                continue
            chunk = chunk.loc[inb].reset_index(drop=True)
            r1, r2 = r1[inb], r2[inb]

            ts = build_tile_stack_slab(
                dev["slab"], B, r1=r1, r2=r2, window1=W, window2=W
            )
            stiles = normalize_tile_stack(
                ts,
                dev["valid1"],
                dev["valid2"],
                evec=dev["evec"],
                ooe=bool(self.expected and self.ooe),
                cis=dev["cis"],
                ignore_diags=int(self.ignore_diags),
            )
            # pooled buffers: data is valid until the NEXT chunk's fill —
            # hooks that retain it across chunks must copy (documented)
            data = assemble_windows_batch(
                stiles, ts.tile_map, B, r1, r2, W, pool="batchhook",
            )
            if "flip" in chunk.columns:
                fl = chunk["flip"].values.astype(bool)
                if fl.any():
                    # rot90(flipud(x)) == anti-transpose per snip
                    data[fl] = np.flip(data[fl], axis=(1, 2)).transpose(
                        0, 2, 1
                    )
            out = postprocess_batch_func(chunk, data)
            if out is not None:
                chunk = out
                if len(chunk) != data.shape[0]:
                    raise ValueError(
                        "postprocess_batch_func must keep the frame "
                        "aligned with the data stack (row-for-row)"
                    )

            if self.coverage_norm:
                covw1 = sliding_window_view(dev["cov1"], W)
                covw2 = sliding_window_view(dev["cov2"], W)
            def _cat_codes(s):
                if isinstance(s.dtype, pd.CategoricalDtype):
                    return s.cat.codes.to_numpy().astype(np.int64)
                return pd.factorize(s, use_na_sentinel=False)[0].astype(
                    np.int64
                )

            kc = _cat_codes(chunk["kind"])
            gc_ = _cat_codes(chunk["group"])
            pair = kc * (int(gc_.max(initial=0)) + 1) + gc_
            order = np.argsort(pair, kind="stable")
            bounds = np.concatenate(
                [[0], np.flatnonzero(np.diff(pair[order])) + 1, [len(pair)]]
            )
            kinds = chunk["kind"]
            groups = chunk["group"]
            for bi in range(len(bounds) - 1):
                sel = order[bounds[bi] : bounds[bi + 1]]
                first = int(sel[0])
                kind = str(kinds.iloc[first])
                g = groups.iloc[first]
                key = g if isinstance(g, (str, int, np.integer)) else tuple(g)
                if self.coverage_norm:
                    cssum = np.nansum(covw1[r1[sel]], axis=0)
                    cesum = np.nansum(covw2[r2[sel]], axis=0)
                else:
                    cssum = np.zeros(W)
                    cesum = np.zeros(W)
                extras_rows = None
                if extra_frame_keys:
                    extras_rows = {}
                    for outkey, col in extra_frame_keys.items():
                        extras_rows[col] = chunk[col].values[sel].tolist()
                # one group -> fold the stack directly (sum order is
                # irrelevant); the [m, W, W] fancy gather would re-fault
                dsel = data if len(bounds) == 2 else data[sel]
                _fold(key, kind, dsel, cssum, cesum, extras_rows)

        shape = self.make_outmap().shape
        sum_func = partial(sum_pups, extra_funcs=extra_sum_funcs)
        if "all" not in outdict["ROI"]:
            outdict["ROI"]["all"] = dict(
                reduce(sum_func, outdict["ROI"].values(), empty_pup(shape))
            )
        if self.control:
            if "all" not in outdict["control"]:
                outdict["control"]["all"] = dict(
                    reduce(
                        sum_func, outdict["control"].values(), empty_pup(shape)
                    )
                )
        if outdict["ROI"]["all"]["n"] > 0:
            logger.info(f"{region1, region2}: {outdict['ROI']['all']['n']}")
        return outdict

    def _pileup_region_hostpath(
        self,
        region1,
        region2,
        groupby,
        modify_2Dintervals_func,
        postprocess_frame_func,
        postprocess_snip_func,
        extra_sum_funcs,
        dev=None,
    ):
        """Per-snip host accumulation over tile-gathered windows — taken when
        user hooks must see snip data or run per-snip extra accumulators
        (reference accumulate_stream, coolpup.py:1236–1283)."""
        outdict = {"ROI": {}, "control": {}}
        stream = self.stream_snips(
            region1,
            region2,
            groupby=groupby,
            modify_2Dintervals_func=modify_2Dintervals_func,
            postprocess_frame_func=postprocess_frame_func,
            dev=dev,
        )
        # buffer hooked snips per (kind, group) and fold them in batches:
        # one stacked nansum per flush replaces a per-snip [2, W, W]
        # nansum (per-snip numpy overhead, not the hook itself, set the
        # pace of this path). Stream order within
        # each group is preserved (buffers append in order, extra funcs
        # run per snip in order at flush). OPAQUE extra funcs (anything
        # not the canonical accumulate_values pattern) may read the
        # accumulator's per-snip intermediate state, so they keep the
        # reference's strictly interleaved per-snip fold.
        batchable = extra_sum_funcs is None or (
            _accumulate_values_frame_keys(extra_sum_funcs) is not None
        )
        buf = {}
        buffered = 0

        def _flush():
            nonlocal buffered
            for (kind, key), snips in buf.items():
                _add_snip_batch(
                    outdict[kind], key, snips, extra_funcs=extra_sum_funcs
                )
            buf.clear()
            buffered = 0

        for snip in stream:
            if snip.get("flip"):
                # rot90(flipud(x)) == anti-transpose (reference coolpup.py:131)
                snip["data"] = np.flip(snip["data"], axis=(0, 1)).T
            out = (
                postprocess_snip_func(snip)
                if postprocess_snip_func is not None
                else snip
            )
            for s in collapse_snips(out):
                key = (
                    s["group"]
                    if isinstance(s["group"], str)
                    else tuple(s["group"])
                )
                if not batchable:
                    _add_snip(
                        outdict[s["kind"]], key, s,
                        extra_funcs=extra_sum_funcs,
                    )
                    continue
                buf.setdefault((s["kind"], key), []).append(s)
                buffered += 1
            if buffered >= 8192:
                _flush()
        _flush()

        shape = self.make_outmap().shape
        sum_func = partial(sum_pups, extra_funcs=extra_sum_funcs)
        if "all" not in outdict["ROI"]:
            outdict["ROI"]["all"] = dict(
                reduce(sum_func, outdict["ROI"].values(), empty_pup(shape))
            )
        if self.control or (self.expected and not self.ooe):
            if "all" not in outdict["control"]:
                outdict["control"]["all"] = dict(
                    reduce(
                        sum_func, outdict["control"].values(), empty_pup(shape)
                    )
                )
        if outdict["ROI"]["all"]["n"] > 0:
            logger.info(f"{region1, region2}: {outdict['ROI']['all']['n']}")
        return outdict

    # -- the full run (reference coolpup.py:1360–1654) ----------------------

    def _region_pairs(self):
        """The work decomposition: cis pairs each view region with itself,
        trans enumerates distinct-chromosome region pairs (reference
        coolpup.py:1416–1429)."""
        if not self.trans:
            return [(r, r) for r in self.view_df.index]
        import itertools

        chrom_of = self.view_df["chrom"]
        return [
            (r1, r2)
            for r1, r2 in itertools.combinations(self.view_df.index, 2)
            if chrom_of[r1] != chrom_of[r2]
        ]

    def _resolve_flipby(self, groupby):
        """Which paired column base decides snip flipping. Returns a base
        name ('strand', or a groupby base for ignore_group_order) or None
        when no flip machinery applies. Encodes the reference's dispatch
        rules (coolpup.py:1431–1476): strand flipping wins, order-flipping
        needs a single unambiguous paired base present in groupby, and
        neither mode makes sense for local or bedpe inputs."""
        igo = self.ignore_group_order

        def _reject_unflippable():
            if self.local:
                raise ValueError(
                    "ignore_group_order doesn't make sense for local pileups"
                )
            if self.kind == "bedpe":
                raise ValueError(
                    "ignore_group_order doesn't make sense for bedpe files"
                )

        if self.flip_negative_strand:
            if igo:
                _reject_unflippable()
                if groupby:
                    warnings.warn(
                        "flip_negative_strand and ignore_group_order leads to "
                        "combining strands, not other groups"
                    )
            return "strand"
        if not igo:
            return None
        if not groupby:
            warnings.warn("Need to specify groupby for ignore_group_order")
            return None
        _reject_unflippable()
        paired = {
            c[:-1] for c in groupby if c.endswith("1") and c[:-1] + "2" in groupby
        }
        if igo is True:
            candidates = sorted(paired)
        elif isinstance(igo, str):
            candidates = [igo]
        elif len(igo) == 1:
            candidates = list(igo)
        else:
            candidates = sorted({c[:-1] for c in igo})
        if len(candidates) == 1 and candidates[0] in paired:
            return candidates[0]
        raise ValueError(
            "Ambiguous ignore_group_order, please provide str or list "
            "of two strings which are in groupby"
        )

    def _compose_modify_func(self, flipby, user_func):
        """Chain flip marking (+ paired-column swap under ignore_group_order)
        in front of the user's modify_2Dintervals_func."""
        if flipby is None:
            return user_func

        def modify(frame):
            frame = flip_mark_intervals(frame, flipby, self.flip_negative_strand)
            if self.ignore_group_order:
                frame = swap_paired_columns_for_flipped(
                    frame, exclude_bases=_GATHER_BASES
                )
            return frame if user_func is None else user_func(frame)

        return modify

    @staticmethod
    def _combine_region_maps(maps, sum_func):
        """Fold per-region {group: pup} maps into one — the sum_pups monoid
        across regions in first-appearance group order (driver-side analog of
        the psum reduction in parallel/mesh.py)."""
        combined = {}
        for m in maps:
            for group, pup in m.items():
                if group in combined:
                    combined[group] = dict(sum_func(combined[group], pup))
                else:
                    combined[group] = dict(pup)
        return combined

    @staticmethod
    def _poison_to_inf(pup):
        """Re-materialize +inf at pixels whose OOE division hit expected == 0:
        the reference accumulates the inf directly (coolpup.py:1154–1156);
        the device kernels track those pixels in a side 'poison' plane so the
        accumulator stays finite-summable."""
        pois = pup.get("poison")
        if pois is not None:
            hot = np.asarray(pois) > 0
            if hot.any():
                data = np.array(pup["data"], dtype=float, copy=True)
                data[hot] = np.inf
                pup["data"] = data
        return pup

    def _finalize_table(self, roi, ctrl, groupby, extra_keys=()):
        """Plain dict/array normalization of combined accumulators into the
        output DataFrame: per-pixel mean, control/expected division, inf
        cleanup, stripe packaging, local symmetrization, groupby columns
        (semantics of reference coolpup.py:1533–1625)."""
        have_control = ctrl is not None

        if self.coverage_norm:
            for pup in roi.values():
                norm_coverage(pup)
            if self.control:
                for pup in ctrl.values():
                    norm_coverage(pup)
            elif self.expected:
                warnings.warn(
                    "Expected can not be normalized to coverage", stacklevel=2
                )

        ctrl_h = ctrl_v = None
        if self.store_stripes and have_control:
            c_all = ctrl["all"]
            with np.errstate(divide="ignore", invalid="ignore"):
                c_norm = c_all["data"] / c_all["num"]
            mid = c_norm.shape[0] // 2
            ctrl_h = np.asarray(c_norm[mid, :], dtype=float)
            ctrl_v = np.asarray(c_norm[:, mid][::-1], dtype=float)

        rows = []
        for group, pup in roi.items():
            row = {}
            with np.errstate(divide="ignore", invalid="ignore"):
                data = pup["data"] / pup["num"]
                if have_control:
                    cpup = ctrl.get(group)
                    if cpup is not None:
                        data = data / (cpup["data"] / cpup["num"])
                        row["control_n"] = cpup["n"]
                        row["control_num"] = cpup["num"]
                    else:
                        data = np.full_like(np.asarray(data, float), np.nan)
                        row["control_n"] = np.nan
                        row["control_num"] = np.nan
            data = np.where(np.isposinf(data), np.nan, data)
            if self.local:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", category=RuntimeWarning)
                    data = np.nanmean(np.dstack((data, data.T)), 2)
            row["data"] = data
            row["n"] = pup["n"]
            row["num"] = pup["num"]

            if self.store_stripes:
                # pup-level coordinates are [n, 6] component blocks on the
                # device path, joined "chrom1.start1..." strings on the
                # per-snip host path (reference format) — normalize both
                parts = []
                for c in pup["coordinates"]:
                    a = np.asarray(c, dtype=object)
                    if a.ndim == 2:
                        parts.append(a)
                    else:
                        parts.append(
                            np.array(str(c).split("."), dtype=object)[None]
                        )
                row["coordinates"] = np.vstack(parts)
                with np.errstate(divide="ignore", invalid="ignore"):
                    for name, stack, cstripe in (
                        ("horizontal_stripe", pup["horizontal_stripe"], ctrl_h),
                        ("vertical_stripe", pup["vertical_stripe"], ctrl_v),
                    ):
                        stripes = np.vstack(stack)
                        if cstripe is not None:
                            stripes = stripes / cstripe
                        if self.local:
                            stripes = _copy_array_halves(stripes)
                        if stripes.dtype == np.float16:
                            # device planes ride f16 through the host
                            # pipeline; the OUTPUT table carries f32
                            stripes = stripes.astype(np.float32)
                        row[name] = stripes

            for key in extra_keys:
                row[key] = pup.get(key)
                if self.control:
                    row[f"control_{key}"] = (ctrl.get(group) or {}).get(key)

            row["group"] = group
            rows.append(row)

        table = pd.DataFrame(rows)
        table.insert(0, "group", table.pop("group"))
        if groupby:
            labels = [
                ("all",) * len(groupby) if g == "all" else tuple(g)
                for g in table["group"]
            ]
            for pos, col in enumerate(groupby):
                table.insert(0, col, [lab[pos] for lab in labels])
        return table

    def _annotation(self):
        """Run-parameter provenance columns (reference coolpup.py:1628–1654
        flushes __dict__; here the set is explicit)."""
        annot = {
            "clr": os.path.abspath(self.clr.filename),
            "resolution": self.resolution,
            "clr_weight_name": self.clr_weight_name,
            "expected": bool(self.expected),
            "expected_value_col": self.expected_value_col,
            "ooe": self.ooe,
            "control": self.control,
            "pad_bins": self.pad_bins,
            "coverage_norm": self.coverage_norm,
            "rescale": self.rescale,
            "rescale_size": self.rescale_size,
            "flip_negative_strand": self.flip_negative_strand,
            "ignore_diags": self.ignore_diags,
            "store_stripes": self.store_stripes,
            "nproc": self.nproc,
            "flank": self.flank,
            "rescale_flank": self.rescale_flank,
            "chroms": str(self.chroms),
            "minshift": self.minshift,
            "maxshift": self.maxshift,
            "nshifts": self.nshifts,
            "trans": self.trans,
            "mindist": self.mindist,
            "maxdist": self.maxdist,
            "local": self.local,
            "subset": self.subset,
            "seed": self.seed,
            "ignore_group_order": self.ignore_group_order,
        }
        return {
            k: (str(v) if isinstance(v, list) else v) for k, v in annot.items()
        }

    def pileupsWithControl(
        self,
        nproc=None,
        groupby=None,
        ignore_group_order=False,
        modify_2Dintervals_func=None,
        postprocess_frame_func=None,
        postprocess_snip_func=None,
        postprocess_batch_func=None,
        extra_sum_funcs=None,
        dual_anchor=False,
    ):
        """Run the full pileup over every region pair and normalize
        (reference coolpup.py:1360–1654 counterpart).

        Extension hooks (reference coolpup.py:1261–1283, lib/puputils.py:39–41):
        ``modify_2Dintervals_func`` / ``postprocess_frame_func`` transform
        vectorized snip frames before gathering; ``postprocess_snip_func``
        sees each snip dict WITH its gathered data (may return one snip, a
        list, or a generator) and ``extra_sum_funcs`` accumulates extra
        per-snip values into output columns — providing either of the last
        two routes the affected regions through the per-snip host path
        (stream_snips).

        ``postprocess_batch_func(frame, data) -> frame`` is the VECTORIZED
        per-snip-data hook: it runs once per coordinate chunk with the
        full [N, W, W] float32 window stack (flip applied) aligned
        row-for-row with the frame, at ~50-100x the per-snip dict
        stream's throughput (see _pileup_region_batchhook). Not
        combinable with postprocess_snip_func; for stripes / rescale /
        expected-emission use postprocess_snip_func instead.

        NOTE: combining ``groupby`` with ``extra_sum_funcs`` inherits the
        reference's sum_pups quirk (reference lib/puputils.py:110–112:
        extra funcs REPLACE the merged pup), so the 'all' row carries only
        the extras — read the per-group rows. Replicated for parity."""
        groupby = groupby or []
        self.ignore_group_order = ignore_group_order
        if nproc is None:
            nproc = self.nproc
        if len(self.chroms) == 0:
            return self.make_outmap(), 0

        flipby = self._resolve_flipby(groupby)
        modify_final = self._compose_modify_func(flipby, modify_2Dintervals_func)

        # coordinate-generation column hint: when every frame transform is
        # known to the engine, the batch builders materialize only the
        # columns the device path reads — untouched feature columns
        # dominated coordgen at millions of pairs
        import functools as _ft

        user_modify_known = modify_2Dintervals_func is None or (
            isinstance(modify_2Dintervals_func, _ft.partial)
            and modify_2Dintervals_func.func is bin_distance_intervals
        )
        column_hint = None
        if (
            user_modify_known
            and postprocess_frame_func is None
            and postprocess_snip_func is None
            and postprocess_batch_func is None
        ):
            column_hint = set(groupby)
            if flipby:
                column_hint |= {flipby + "1", flipby + "2"}

        # pipeline region ingest (HDF5 -> CSR -> staging) with device compute:
        # the reference's process pool over regions (coolpup.py:1502–1508)
        # becomes prefetch threads feeding one accelerator
        from concurrent.futures import ThreadPoolExecutor

        from ..observability import PhaseTimers, device_trace

        self._timers = timers = PhaseTimers()

        def _ckpt_path(r1, r2):
            safe = _re.sub(r"[^A-Za-z0-9_.-]", "_", f"{r1}__{r2}")
            return os.path.join(self.checkpoint_dir, safe + ".pkl")

        def _run_one(r1, r2, dev):
            # per-region-pair accumulator checkpointing: the natural resume
            # unit of the decomposition (SURVEY §5)
            if self.checkpoint_dir:
                path = _ckpt_path(r1, r2)
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        return pickle.load(f)
            if dev is None:
                dev = self._stage_region(r1, r2)
            out = self.pileup_region(
                r1,
                r2,
                groupby=groupby,
                modify_2Dintervals_func=modify_final,
                postprocess_frame_func=postprocess_frame_func,
                postprocess_snip_func=postprocess_snip_func,
                postprocess_batch_func=postprocess_batch_func,
                extra_sum_funcs=extra_sum_funcs,
                dev=dev,
                dual_anchor=dual_anchor,
                column_hint=column_hint,
            )
            if self.checkpoint_dir:
                os.makedirs(self.checkpoint_dir, exist_ok=True)
                tmp = _ckpt_path(r1, r2) + ".tmp"
                with open(tmp, "wb") as f:
                    pickle.dump(out, f)
                os.replace(tmp, _ckpt_path(r1, r2))
            return out

        def _stage(r1, r2):
            if self.checkpoint_dir and os.path.exists(_ckpt_path(r1, r2)):
                # checkpoint resume skips compute entirely — don't pay the
                # staging it exists to avoid
                return None
            return self._stage_region(r1, r2)

        pairs = self._region_pairs()
        multihost = False
        if self.mesh is not None:
            import jax

            multihost = jax.process_count() > 1
        if multihost:
            # process axis: each host piles up its share of region pairs; local
            # results are exchanged after the loop (parallel/distributed.py)
            from ..parallel.distributed import local_region_pairs

            pairs = local_region_pairs(pairs)
        n_prefetch = max(1, min(4, nproc if nproc > 0 else 4))
        pileups = []
        with device_trace(self.trace_dir), ThreadPoolExecutor(
            max_workers=n_prefetch
        ) as pool:
            futures = {}
            for idx, (r1, r2) in enumerate(pairs[:n_prefetch]):
                futures[idx] = pool.submit(_stage, r1, r2)
            for idx, (r1, r2) in enumerate(pairs):
                dev = futures.pop(idx).result()
                nxt = idx + n_prefetch
                if nxt < len(pairs):
                    futures[nxt] = pool.submit(_stage, *pairs[nxt])
                pileups.append(_run_one(r1, r2, dev))
        timers.log_summary()
        # last-run phase totals, readable by benches/tools after pileup()
        # (which constructs its own PileUpper): SURVEY §5 observability
        global LAST_TIMERS
        LAST_TIMERS = timers

        if multihost:
            from ..parallel.distributed import allreduce_region_maps

            pileups = allreduce_region_maps(pileups)

        sum_func = partial(sum_pups, extra_funcs=extra_sum_funcs)
        roi = self._combine_region_maps((p["ROI"] for p in pileups), sum_func)
        ctrl = None
        if self.control or (self.expected and not self.ooe):
            ctrl = self._combine_region_maps(
                (p["control"] for p in pileups), sum_func
            )
        for pup in roi.values():
            self._poison_to_inf(pup)
        if ctrl is not None:
            for pup in ctrl.values():
                self._poison_to_inf(pup)

        table = self._finalize_table(
            roi, ctrl, groupby, extra_keys=tuple(extra_sum_funcs or ())
        )
        logger.info(
            f"Total number of piled up windows: {int(roi['all']['n'])}"
        )
        for name, value in self._annotation().items():
            table[name] = [value] * len(table)
        return table

    # -- grouped wrappers (reference coolpup.py:1656–1919) ------------------

    def pileupsByStrandWithControl(
        self, nproc=None, groupby=None, ignore_group_order=False
    ):
        """Group by strand pair; adds the 'orientation' label column
        (reference coolpup.py:1656–1694)."""
        pups = self.pileupsWithControl(
            nproc=nproc,
            groupby=["strand1", "strand2"] + list(groupby or []),
            ignore_group_order=ignore_group_order,
        )
        pups.insert(0, "orientation", _orientation_labels(pups))
        return pups

    def pileupsByWindowWithControl(self, nproc=None):
        """One pup per anchor window: every snip contributes to both of its
        anchors' groups (reference coolpup.py:1696–1756).

        Groups ride the INTEGER anchor id (coords adds ``anchor_idx``):
        factorizing 2x the snip stream of (chrom, start, end) python
        tuples dominated by-window walls; the int codes factorize on the
        numpy fast path and map back to window labels once per group."""
        if self.local:
            raise ValueError("Cannot do by-window pileups for local")

        if self.CC.kind == "bed" and not self.rescale:
            pups = self.pileupsWithControl(nproc=nproc, dual_anchor=True)
            iv = self.CC.intervals
            codes = iv["anchor_idx"].to_numpy()
            _, first = np.unique(codes, return_index=True)
            ch = iv["chrom"].to_numpy()
            st = iv["start"].to_numpy()
            en = iv["end"].to_numpy()
            lab = {
                int(codes[i]): (ch[i], int(st[i]), int(en[i]))
                for i in first
            }
            anchors = [
                ("all", -1, -1) if g == "all" else lab[int(g)]
                for g in pups["group"]
            ]
        else:
            # bedpe rows have no shared anchor index, and rescale's
            # variable-extent windows don't fit the dual-anchor fast path —
            # use the frame-duplication postprocess (reference
            # group_by_region, puputils.py:218-223) with tuple groups
            pups = self.pileupsWithControl(
                nproc=nproc, postprocess_frame_func=group_by_region_frame
            )
            anchors = [
                ("all", -1, -1) if g == "all" else tuple(g)
                for g in pups["group"]
            ]
        pups = pups.drop(columns="group")
        pups.insert(0, "end", np.array([a[2] for a in anchors], dtype=int))
        pups.insert(0, "start", np.array([a[1] for a in anchors], dtype=int))
        pups.insert(0, "chrom", [a[0] for a in anchors])
        return sort_bedframe(pups, view_df=self.view_df.reset_index())

    def _resolve_distance_edges(self, distance_edges):
        """Validate user edges; separations below the engine's minimum
        snappable distance collapse onto mindist (reference
        coolpup.py:1770–1785)."""
        if isinstance(distance_edges, str) and distance_edges == "default":
            return "default"
        if not all(isinstance(n, (int, np.integer)) for n in distance_edges):
            raise ValueError("Distance edges must be integers")
        edges = np.sort(np.asarray(distance_edges))
        return list(np.maximum(edges, self.mindist))

    def _pileups_binned_by_distance(
        self, nproc, distance_edges, groupby, ignore_group_order, sort_cols
    ):
        """Shared by-distance machinery: annotate bands at the frame level,
        group on them, drop out-of-band rows, label separations, order rows
        with 'all' last."""
        edges = self._resolve_distance_edges(distance_edges)
        pups = self.pileupsWithControl(
            nproc=nproc,
            modify_2Dintervals_func=partial(
                bin_distance_intervals, band_edges=edges
            ),
            groupby=groupby,
            ignore_group_order=ignore_group_order,
        )
        if "orientation" in sort_cols:
            pups.insert(0, "orientation", _orientation_labels(pups))
        pups = pups[pups["distance_band"] != ()].reset_index(drop=True)
        pups.insert(
            0,
            "separation",
            [_separation_label(band) for band in pups["distance_band"]],
        )
        is_all = (pups["separation"] == "all").values
        body = pups.loc[~is_all].sort_values(sort_cols)
        return pd.concat([body, pups.loc[is_all]], ignore_index=True)

    def pileupsByDistanceWithControl(
        self,
        nproc=None,
        distance_edges="default",
        groupby=None,
        ignore_group_order=False,
    ):
        """Group by distance band (reference coolpup.py:1757–1833)."""
        if self.trans:
            raise ValueError("Cannot do by-distance pileups for trans")
        if self.local:
            raise ValueError("Cannot do by-distance pileups for local")
        return self._pileups_binned_by_distance(
            nproc,
            distance_edges,
            ["distance_band"] + list(groupby or []),
            ignore_group_order,
            sort_cols=["distance_band"],
        )

    def pileupsByStrandByDistanceWithControl(
        self,
        nproc=None,
        distance_edges="default",
        groupby=None,
        ignore_group_order=False,
    ):
        """Group by strand pair × distance band (reference
        coolpup.py:1835–1919)."""
        if self.trans:
            raise ValueError("Cannot do by-distance pileups for trans")
        return self._pileups_binned_by_distance(
            nproc,
            distance_edges,
            ["strand1", "strand2", "distance_band"] + list(groupby or []),
            ignore_group_order,
            sort_cols=["orientation", "distance_band"],
        )


def pileup(
    clr,
    features,
    features_format="bed",
    view_df=None,
    expected_df=None,
    expected_value_col="balanced.avg",
    clr_weight_name="weight",
    flank=100000,
    minshift=10**5,
    maxshift=10**6,
    nshifts=0,
    ooe=True,
    mindist="auto",
    maxdist=None,
    min_diag=2,
    subset=0,
    by_window=False,
    by_strand=False,
    by_distance=False,
    groupby=None,
    ignore_group_order=False,
    flip_negative_strand=False,
    local=False,
    coverage_norm=False,
    trans=False,
    rescale=False,
    rescale_flank=1,
    rescale_size=99,
    store_stripes=False,
    tile_f16=True,
    nproc=1,
    seed=None,
    mesh=None,
    backend="auto",
):
    """One-shot pileup API (reference coolpup.py:1922–2279; same parameters,
    plus ``mesh``: a jax.sharding.Mesh with a "loci" axis — or "auto" — to
    shard every region's snip stream across devices, psum-reducing the
    accumulators, and ``backend``: one of BACKENDS (PileUpper's knob;
    any other value raises ValueError)."""
    groupby = groupby or []
    distance_edges = "default"
    if by_distance is not False:
        if local:
            raise ValueError(
                "Can't do local pileups by distance, please specify only one "
                "of those arguments"
            )
        if isinstance(by_distance, (list, np.ndarray)):
            try:
                distance_edges = [int(i) for i in by_distance]
            except Exception as e:
                raise ValueError(
                    "Distance bin edges have to be an iterable of integers"
                ) from e
            by_distance = True
        elif by_distance is True or by_distance == "default":
            by_distance = True
        else:
            raise ValueError(
                "Invalid by_distance value: True, 'default' or a list of "
                "integers"
            )

    if not rescale:
        rescale_flank = None

    if view_df is None:
        view_df = make_cooler_view(clr)
    else:
        is_compatible_viewframe(
            view_df, clr, check_sorting=True, raise_errors=True
        )

    control = nshifts > 0

    if expected_df is None:
        expected = None
        expected_value_col = None
    else:
        expected = True
        is_valid_expected(
            expected_df,
            "trans" if trans else "cis",
            view_df,
            verify_cooler=clr,
            expected_value_cols=[expected_value_col],
            raise_errors=True,
        )

    if mindist is None:
        mindist = "auto"
    if maxdist is None:
        maxdist = np.inf
    if rescale and rescale_size % 2 == 0:
        raise ValueError("Please provide an odd rescale_size")

    chroms = list(view_df["chrom"].unique())

    if by_window:
        if features_format != "bed":
            raise ValueError(
                "Can't make by-window pileups without making combinations"
            )
        if local:
            raise ValueError("Can't make local by-window pileups")

    CC = CoordCreator(
        features=features,
        resolution=clr.binsize,
        features_format=features_format,
        flank=flank,
        rescale_flank=rescale_flank,
        chroms=chroms,
        minshift=minshift,
        maxshift=maxshift,
        nshifts=nshifts,
        mindist=mindist,
        maxdist=maxdist,
        local=local,
        subset=subset,
        seed=seed,
        trans=trans,
    )
    PU = PileUpper(
        clr=clr,
        CC=CC,
        view_df=view_df,
        clr_weight_name=clr_weight_name,
        expected=expected_df if expected else False,
        expected_value_col=expected_value_col,
        ooe=ooe,
        control=control,
        coverage_norm=coverage_norm,
        rescale=rescale,
        rescale_size=rescale_size,
        flip_negative_strand=flip_negative_strand,
        ignore_diags=min_diag,
        store_stripes=store_stripes,
        tile_f16=tile_f16,
        nproc=nproc,
        mesh=mesh,
        backend=backend,
    )

    if by_window:
        if groupby:
            warnings.warn("by-window not compatible with additional groupby")
        pups = PU.pileupsByWindowWithControl(nproc=nproc)
    elif by_strand and by_distance:
        pups = PU.pileupsByStrandByDistanceWithControl(
            nproc=nproc,
            distance_edges=distance_edges,
            groupby=groupby,
            ignore_group_order=ignore_group_order,
        )
    elif by_strand:
        pups = PU.pileupsByStrandWithControl(
            nproc=nproc, groupby=groupby, ignore_group_order=ignore_group_order
        )
    elif by_distance:
        pups = PU.pileupsByDistanceWithControl(
            nproc=nproc,
            distance_edges=distance_edges,
            groupby=groupby,
            ignore_group_order=ignore_group_order,
        )
    else:
        pups = PU.pileupsWithControl(
            nproc=nproc, groupby=groupby, ignore_group_order=ignore_group_order
        )
    pups["by_window"] = bool(by_window)
    pups["by_strand"] = bool(by_strand) and not by_window
    pups["by_distance"] = bool(by_distance) and not by_window
    pups["groupby"] = [groupby] * len(pups)
    pups["expected"] = pups["expected"].fillna(False)
    pups["cooler"] = os.path.splitext(os.path.basename(clr.filename))[0]
    return pups
