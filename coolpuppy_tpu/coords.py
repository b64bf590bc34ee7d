"""Vectorized coordinate engine.

The counterpart of the reference's `CoordCreator` (reference
coolpup.py:150–749), re-designed for a device pipeline: instead of a Python
generator of per-snip dicts, it yields *batches* — DataFrames built by
vectorized numpy/pandas ops — which the engine lowers to integer index arrays
for the device gather kernel. Enumeration of all-vs-all BED combinations is a
k-th-superdiagonal sweep like the reference (coolpup.py:682–714) but vectorized
per chunk and with early termination once the k-diagonal's minimum pair
distance exceeds ``maxdist`` (valid because centers are sorted; the reference
enumerates all O(N²) pairs regardless).
"""

from __future__ import annotations

import warnings
import zlib

import numpy as np
import pandas as pd

from .genomics.intervals import (
    expand_intervals,
    expand_intervals_2d,
    natsorted,
)

try:  # optional C++ pair enumeration (coolpuppy_tpu/native)
    from .native import enumerate_pairs as _native_enumerate_pairs
except Exception:  # pragma: no cover - native ext is optional
    _native_enumerate_pairs = None

DEFAULT_BAND_EDGES = np.append([0], 50000 * 2 ** np.arange(30))


def _chrom_as_str_categorical(col):
    """Chromosome column -> categorical with python-str categories in
    LEXICOGRAPHIC order.

    Equivalent to the reference's ``astype(str)`` (coolpup.py:270, 276) for
    every downstream consumer (equality filters, set/unique membership,
    grouping, label formatting, sort order — categories are reordered to
    str order so categorical sorts match astype(str) sorts even for
    numeric chrom columns), but O(unique) instead of O(rows): a plain
    astype(str) on a 2M-row Arrow-backed bedpe column iterates per element.
    Distinct values
    whose str() forms collide (e.g. 1 and "1") fall back to the
    reference's elementwise cast."""
    if isinstance(col.dtype, pd.CategoricalDtype):
        cat = col
    else:
        cat = col.astype("category")
    cats = list(cat.cat.categories)
    strcats = [x if isinstance(x, str) else str(x) for x in cats]
    if len(set(strcats)) != len(strcats):
        return col.astype(str).astype("category")
    if strcats != cats:
        cat = cat.cat.rename_categories(strcats)
    if strcats != sorted(strcats):
        cat = cat.cat.reorder_categories(sorted(strcats))
    return cat


def bin_distance_intervals(intervals, band_edges="default"):
    """Annotate a 'distance_band' (lo, hi) tuple per row from 'distance'
    (reference coolpup.py:28–51)."""
    if isinstance(band_edges, str) and band_edges == "default":
        band_edges = DEFAULT_BAND_EDGES
    band_edges = np.asarray(band_edges)
    edge_ids = np.searchsorted(band_edges, intervals["distance"], side="right")
    # band tuples materialized per unique edge only (vs one per row)
    uniq, inv = np.unique(edge_ids, return_inverse=True)
    categories = [tuple(band_edges[i - 1 : i + 1]) for i in uniq]
    intervals["distance_band"] = pd.Categorical.from_codes(
        inv, categories=pd.Index(categories, tupleize_cols=False)
    )
    return intervals


def assign_groups(intervals, groupby=None):
    """Add a 'group' column — 'all' or the tuple of groupby values
    (reference coolpup.py:54–75). Group tuples are materialized only per
    UNIQUE value combination and stored as a categorical: building millions
    of per-row python tuples dominated host time at scale."""
    if not groupby:
        # categorical constant: a plain string column makes every engine
        # chunk re-factorize millions of identical 'all' objects
        intervals["group"] = pd.Categorical.from_codes(
            np.zeros(len(intervals), np.int8), categories=["all"]
        )
        return intervals
    codes, uniques = zip(
        *(
            pd.factorize(intervals[col], use_na_sentinel=False)
            for col in groupby
        )
    )
    sizes = [len(u) for u in uniques]
    combined = np.ravel_multi_index([np.asarray(c) for c in codes], sizes)
    ucomb, inv = np.unique(combined, return_inverse=True)
    percol = np.unravel_index(ucomb, sizes)
    categories = [
        tuple(uniques[d][percol[d][i]] for d in range(len(groupby)))
        for i in range(len(ucomb))
    ]
    intervals["group"] = pd.Categorical.from_codes(
        inv, categories=pd.Index(categories, tupleize_cols=False)
    )
    return intervals


def flip_mark_intervals(intervals, flipby, flip_negative_strand):
    """Mark snips to flip: negative strand1, or group order
    ``flipby1 > flipby2`` (reference coolpup.py:118–125)."""
    if flip_negative_strand:
        intervals["flip"] = intervals["strand1"] == "-"
    else:
        intervals["flip"] = intervals[f"{flipby}1"] > intervals[f"{flipby}2"]
    return intervals


def swap_paired_columns_for_flipped(intervals, exclude_bases=()):
    """For rows marked flip=True, swap every paired column base1/base2 —
    the vectorized analog of the snip-dict swap in reference
    coolpup.py:128–147 (which swaps all paired keys after snipping). Bin
    coordinates used for gathering are excluded: the gather uses the original
    orientation plus an in-kernel anti-transpose."""
    flip = intervals["flip"].values.astype(bool)
    if not flip.any():
        return intervals
    cols = set(intervals.columns)
    bases = sorted(
        {
            c[:-1]
            for c in cols
            if c.endswith("1") and (c[:-1] + "2") in cols and c[:-1] not in exclude_bases
        }
    )
    for base in bases:
        a, b = intervals[base + "1"].values.copy(), intervals[base + "2"].values.copy()
        av, bv = a.copy(), b.copy()
        av[flip], bv[flip] = b[flip], a[flip]
        intervals[base + "1"] = av
        intervals[base + "2"] = bv
    return intervals


class CoordCreator:
    """Same constructor surface as the reference CoordCreator
    (reference coolpup.py:151–257)."""

    def __init__(
        self,
        features,
        resolution,
        *,
        features_format="auto",
        flank=100000,
        rescale_flank=None,
        chroms="all",
        minshift=10**5,
        maxshift=10**6,
        nshifts=10,
        mindist="auto",
        maxdist=None,
        local=False,
        subset=0,
        trans=False,
        seed=None,
        chunk_size=262_144,
    ):
        self.intervals = features.copy()
        self.resolution = int(resolution)
        self.features_format = features_format
        self.flank = flank
        self.rescale_flank = rescale_flank
        self.chroms = chroms
        self.minshift = minshift
        self.maxshift = maxshift
        self.nshifts = nshifts
        self.trans = trans
        self.chunk_size = int(chunk_size)
        if mindist == "auto":
            self.mindist = 2 * self.flank + 2 * self.resolution
        else:
            self.mindist = mindist
            if self.trans:
                warnings.warn("Ignoring mindist when using trans", stacklevel=2)
                self.mindist = 0
        if maxdist is None or maxdist == np.inf:
            self.maxdist = np.inf
        else:
            self.maxdist = maxdist
            if self.trans:
                warnings.warn("Ignoring maxdist when using trans", stacklevel=2)
                self.maxdist = np.inf
        self.local = local
        self.subset = subset
        self.seed = seed
        self.process()

    # -- preprocessing (reference coolpup.py:259–385) ----------------------

    def process(self):
        if self.features_format in (None, "auto"):
            if {"chrom1", "start1", "end1", "chrom2", "start2", "end2"}.issubset(
                self.intervals.columns
            ):
                self.kind = "bedpe"
            elif {"chrom", "start", "end"}.issubset(self.intervals.columns):
                self.kind = "bed"
            else:
                raise ValueError(
                    "Can't determine kind of input; name columns "
                    "chrom/start/end (bed) or chrom1/.../end2 (bedpe)"
                )
        else:
            self.kind = self.features_format

        if self.subset > 0:
            self.intervals = self._subset(self.intervals)

        if self.kind == "bed":
            assert {"chrom", "start", "end"}.issubset(self.intervals.columns)
            self.intervals["chrom"] = _chrom_as_str_categorical(
                self.intervals["chrom"]
            )
            self.intervals["center"] = (
                self.intervals["start"] + self.intervals["end"]
            ) / 2
            self.intervals = expand_intervals(
                self.intervals, self.flank, self.resolution, self.rescale_flank
            )
        else:
            assert {
                "chrom1",
                "start1",
                "end1",
                "chrom2",
                "start2",
                "end2",
            }.issubset(self.intervals.columns)
            for c in ("chrom1", "chrom2"):
                self.intervals[c] = _chrom_as_str_categorical(
                    self.intervals[c]
                )
            # sort NOW, while the frame is just the input columns (few
            # consolidated blocks -> cheap take); the derived
            # center/distance/exp_* columns are row-wise, so computing
            # them after the sort is identical — sorting the 14-column
            # frame in _binnify instead cost ~1.8 s at 2M bedpe rows
            self.intervals = self._lex_sorted(
                self.intervals, ["chrom1", "chrom2", "start1", "start2"]
            )
            self.intervals["center1"] = (
                self.intervals["start1"] + self.intervals["end1"]
            ) / 2
            self.intervals["center2"] = (
                self.intervals["start2"] + self.intervals["end2"]
            ) / 2
            self.intervals["distance"] = (
                self.intervals["center2"] - self.intervals["center1"]
            )
            dist = self.intervals["distance"].abs()
            keep = (self.mindist <= dist) & (dist <= self.maxdist)
            if not keep.all():  # all-True take still copies the frame
                self.intervals = self.intervals[keep].reset_index(drop=True)
            self.intervals = expand_intervals_2d(
                self.intervals, self.flank, self.resolution, self.rescale_flank
            )

        if self.intervals.shape[0] == 0:
            warnings.warn(
                "No regions in features (maybe all below mindist?), "
                "returning empty output",
                stacklevel=2,
            )
            self.final_chroms = []
            self.empty = True
            return
        self.empty = False

        # set(Series) iterates every row; unique() is O(categories)
        if self.kind == "bed":
            basechroms = set(self.intervals["chrom"].unique())
        else:
            if self.local:
                raise ValueError("Can't make local with both sides of loops defined")
            if self.trans:
                basechroms = set(self.intervals["chrom1"].unique()) | set(
                    self.intervals["chrom2"].unique()
                )
            else:
                basechroms = set(self.intervals["chrom1"].unique()) & set(
                    self.intervals["chrom2"].unique()
                )
        self.basechroms = natsorted(basechroms)
        if self.chroms == "all":
            self.final_chroms = natsorted(basechroms)
        else:
            self.final_chroms = natsorted(set(self.chroms) & set(self.basechroms))
        if len(self.final_chroms) == 0:
            raise ValueError(
                "No chromosomes are in common between the coordinate "
                "file and the cooler file"
            )

        if self.trans and self.local:
            raise ValueError("Cannot do local with trans=True")

        self.intervals = self._binnify(self.intervals)
        if self.kind == "bed":
            # stable integer anchor id: lets by-window grouping ride int
            # group codes instead of 14M python (chrom, start, end) tuples
            # (engine pileupsByWindowWithControl). DUPLICATE intervals
            # share one id — by-window must merge them into one window
            # group (reference group_by_region keys on the coordinates)
            key = (
                self.intervals["chrom"].astype(str)
                + ":"
                + self.intervals["start"].astype(str)
                + "-"
                + self.intervals["end"].astype(str)
            )
            codes, _ = pd.factorize(key)
            self.intervals = self.intervals.assign(
                anchor_idx=codes.astype(np.int64)
            )

    def bedpe2bed(self, df, ends=True, how="center"):
        """Collapse bedpe rows to bed (reference coolpup.py:463–487):
        ends=True stacks both anchors; otherwise one interval per pair,
        spanning outer/inner coordinates or anchor centers."""
        if ends:
            df1 = df[["chrom1", "start1", "end1"]].copy()
            df1.columns = ["chrom", "start", "end"]
            df2 = df[["chrom2", "start2", "end2"]].copy()
            df2.columns = ["chrom", "start", "end"]
            return (
                pd.concat([df1, df2])
                .sort_values(["chrom", "start", "end"])
                .reset_index(drop=True)
            )
        df = df.copy()
        if how == "center":
            df["chrom"] = df["chrom1"]
            df["start"] = ((df["start1"] + df["end1"]) // 2).astype(int)
            df["end"] = ((df["start2"] + df["end2"]) // 2).astype(int)
        elif how == "outer":
            df = df[["chrom1", "start1", "end2"]]
            df.columns = ["chrom", "start", "end"]
        elif how == "inner":
            df = df[["chrom1", "end1", "start2"]]
            df.columns = ["chrom", "start", "end"]
        return df[["chrom", "start", "end"]]

    def _subset(self, df):
        if self.subset > 0 and self.subset < len(df):
            return df.sample(self.subset, random_state=self.seed)
        return df

    @staticmethod
    def _lex_sorted(intervals, cols):
        """sort_values(cols) via raw arrays: an O(n) vectorized
        already-sorted check first (free for pre-sorted files and for the
        engine's own re-checks), else np.lexsort + ONE block-wise
        positional take — pandas sort_values re-consolidated the whole
        block manager.
        Categorical chroms sort by category code."""
        keys = []
        for c in cols:
            col = intervals[c]
            if isinstance(col.dtype, pd.CategoricalDtype):
                keys.append(col.cat.codes.to_numpy())
            else:
                keys.append(col.to_numpy())
        n = len(intervals)
        if n <= 1:
            return intervals.reset_index(drop=True)
        # lexicographically sorted iff at each boundary the first
        # non-tied key increases
        tie = np.ones(n - 1, bool)
        unsorted = False
        for k in keys:
            a, b = k[:-1], k[1:]
            if not tie.any():
                break
            if ((a > b) & tie).any():
                unsorted = True
                break
            tie &= a == b
        if not unsorted:
            return intervals.reset_index(drop=True)
        order = np.lexsort(tuple(reversed(keys)))
        return intervals.take(order).reset_index(drop=True)

    def _binnify(self, intervals):
        """Snap expanded intervals to the bin grid (reference
        coolpup.py:489–527)."""
        res = self.resolution

        def _floor_div(col):
            a = col.to_numpy()
            if a.dtype.kind in "iu":  # int // == floor for any sign
                return a.astype(np.int64) // res
            return np.floor(a / res).astype(int)

        def _ceil_div(col):
            a = col.to_numpy()
            if a.dtype.kind in "iu":
                return -((-a.astype(np.int64)) // res)
            return np.ceil(a / res).astype(int)

        if self.kind == "bed":
            intervals = self._lex_sorted(intervals, ["chrom", "start"])
            intervals["stBin"] = _floor_div(intervals["exp_start"])
            intervals["endBin"] = _ceil_div(intervals["exp_end"])
            intervals["exp_start"] = intervals["stBin"] * res
            intervals["exp_end"] = intervals["endBin"] * res
        else:
            intervals = self._lex_sorted(
                intervals, ["chrom1", "chrom2", "start1", "start2"]
            )
            for side in ("1", "2"):
                intervals[f"stBin{side}"] = _floor_div(
                    intervals[f"exp_start{side}"]
                )
                intervals[f"endBin{side}"] = _ceil_div(
                    intervals[f"exp_end{side}"]
                )
                intervals[f"exp_start{side}"] = intervals[f"stBin{side}"] * res
                intervals[f"exp_end{side}"] = intervals[f"endBin{side}"] * res
        return intervals

    # -- control shifts (reference coolpup.py:387–453) ---------------------

    def _rng(self, region_tag, salt=0):
        """Deterministic, host-count-invariant RNG keyed by (seed, region,
        chunk) — replaces the reference's global np.random state
        (coolpup.py:392–404), so results don't depend on region execution
        order or process count."""
        def _norm(tag):
            if tag is None:
                return "none"
            if isinstance(tag, (tuple, list)):
                return "|".join(_norm(t) for t in tag)
            if isinstance(tag, (int, np.integer)):
                return str(int(tag))
            return str(tag)

        entropy = [
            0 if self.seed is None else int(self.seed),
            zlib.crc32(_norm(region_tag).encode()),
            int(salt),
        ]
        if self.seed is None:
            return np.random.default_rng()
        return np.random.default_rng(np.random.SeedSequence(entropy))

    def control_regions(self, intervals2d, nshifts=0, rng=None):
        """Tag ROI rows; append nshifts shifted control copies.

        Cis controls shift both anchors by one signed bp amount; trans
        controls shift the two anchors independently (reference
        coolpup.py:387–453; unlike the reference, the side-2 *bin* shift uses
        the side-2 bp shift — upstream applies the side-1 shift to both bin
        axes, contradicting its own bp coordinates)."""
        res = self.resolution
        if nshifts <= 0:
            # shallow copy: we only ADD a column. ALIASING CONTRACT: the
            # returned ROI rows share column arrays with the caller's frame —
            # downstream hooks must assign whole columns, not mutate cells in
            # place (all built-in hooks do)
            intervals2d = intervals2d.copy(deep=False)
            intervals2d["kind"] = pd.Categorical.from_codes(
                np.zeros(len(intervals2d), np.int8),
                categories=["ROI", "control"],
            )
            return intervals2d
        if rng is None:
            rng = self._rng("anon")
        # ROI + nshifts control copies in ONE positional raw-array take per
        # column (dtype-preserving incl. categoricals; no concat re-copy,
        # no Series index machinery, no post-construction column
        # assignments — each of those re-split consolidated blocks, and at
        # 10 shifts the concat+consolidate path was ~30s per 39M rows)
        n = len(intervals2d)
        n_ctrl = n * nshifts
        reps = np.concatenate([np.arange(n), np.tile(np.arange(n), nshifts)])
        shift = rng.integers(self.minshift, self.maxshift, n_ctrl) * rng.choice(
            [-1, 1], n_ctrl
        )
        if self.trans:
            shift2 = rng.integers(
                self.minshift, self.maxshift, n_ctrl
            ) * rng.choice([-1, 1], n_ctrl)
        else:
            shift2 = shift
        pad = np.zeros(n)
        sh1 = np.concatenate([pad, shift])
        sh2 = np.concatenate([pad, shift2])
        bsh1 = np.concatenate(
            [pad.astype(int), np.round(shift / res).astype(int)]
        )
        bsh2 = np.concatenate(
            [pad.astype(int), np.round(shift2 / res).astype(int)]
        )
        shifted = {
            "exp_start1": sh1, "exp_end1": sh1, "center1": sh1,
            "exp_start2": sh2, "exp_end2": sh2, "center2": sh2,
            "stBin1": bsh1, "endBin1": bsh1,
            "stBin2": bsh2, "endBin2": bsh2,
        }
        data = {}
        for c in intervals2d.columns:
            col = intervals2d[c]
            if c in shifted:
                data[c] = np.asarray(col).take(reps) + shifted[c]
            elif isinstance(col.dtype, np.dtype):
                data[c] = col.to_numpy().take(reps)
            else:
                data[c] = col.array.take(reps)
        data["kind"] = pd.Categorical.from_codes(
            np.repeat(np.array([0, 1], np.int8), [n, n_ctrl]),
            categories=["ROI", "control"],
        )
        return pd.DataFrame(data)

    # -- region filtering (reference coolpup.py:529–596) -------------------

    def filter_bed_region(self, region):
        chrom, start, end = region
        iv = self.intervals
        return iv[
            (iv["chrom"] == chrom) & (iv["start"] >= start) & (iv["end"] < end)
        ].reset_index(drop=True)

    def filter_bedpe_region(self, region):
        chrom, start, end = region
        iv = self.intervals
        return iv[
            (iv["chrom1"] == chrom)
            & (iv["chrom2"] == chrom)
            & (iv["start1"] >= start)
            & (iv["end1"] < end)
            & (iv["start2"] >= start)
            & (iv["end2"] < end)
        ].reset_index(drop=True)

    def filter_bedpe_trans_pairs(self, region1, region2):
        chrom1, start1, end1 = region1
        chrom2, start2, end2 = region2
        iv = self.intervals
        fwd = iv[
            (iv["chrom1"] == chrom1)
            & (iv["chrom2"] == chrom2)
            & (iv["start1"] >= start1)
            & (iv["end1"] < end1)
            & (iv["start2"] >= start2)
            & (iv["end2"] < end2)
        ].reset_index(drop=True)
        rev = iv[
            (iv["chrom2"] == chrom1)
            & (iv["chrom1"] == chrom2)
            & (iv["start2"] >= start1)
            & (iv["end2"] < end1)
            & (iv["start1"] >= start2)
            & (iv["end1"] < end2)
        ].reset_index(drop=True)
        # swap sides of reversed rows so side 1 is always region1-frame
        # (the reference concatenates without swapping, coolpup.py:565–587,
        # which mis-rebases reversed bedpe trans pairs — fixed here)
        if len(rev):
            cols = set(rev.columns)
            mapping = {}
            for c in cols:
                if c.endswith("1") and (c[:-1] + "2") in cols:
                    mapping[c] = c[:-1] + "2"
                    mapping[c[:-1] + "2"] = c
            rev = rev.rename(columns=mapping)
        return pd.concat([fwd, rev]).reset_index(drop=True)

    # -- batch generation (replaces pos_stream, reference coolpup.py:598–749)

    def batches(
        self,
        region1,
        region2=None,
        control=False,
        groupby=None,
        modify_2Dintervals_func=None,
        columns=None,
    ):
        """Yield vectorized snip DataFrames for a region (pair).

        Each frame carries chrom/start/end/center/exp_*/stBin/endBin for both
        sides plus 'kind', 'group' and any feature annotations. The union of
        all frames is semantically the reference's pos_stream output
        (coolpup.py:598–746)."""
        groupby = groupby or []
        if self.empty:
            return
        use = self._column_subset(columns)
        if self.kind == "bedpe":
            yield from self._batches_bedpe(
                region1, region2, control, groupby,
                modify_2Dintervals_func, use,
            )
        elif self.local:
            yield from self._batches_local(
                region1, control, groupby, modify_2Dintervals_func, use
            )
        elif self.trans:
            yield from self._batches_trans_bed(
                region1, region2, control, groupby,
                modify_2Dintervals_func, use,
            )
        else:
            yield from self._batches_cis_bed(
                region1, control, groupby, modify_2Dintervals_func, use
            )

    def _column_subset(self, columns):
        """Resolve a suffixed-column hint (engine fast path) to the BASE
        interval columns each side must materialize; None -> all columns.
        Frame assembly is take-per-column — at millions of pairs the
        untouched feature columns (names, scores, Arrow strings) dominated
        coordinate-generation time, so the engine hints exactly what its
        device path reads (host coordinate generation sets the
        pace of plain runs)."""
        if columns is None:
            return None
        if self.kind == "bedpe":
            # bedpe rows already carry suffixed columns; 'distance' is a
            # stored column here (the cis-bed builder synthesizes it), so
            # by-distance grouping needs it retained
            base = {
                c for c in columns
                if c in self.intervals.columns
            }
            base |= {"stBin1", "endBin1", "stBin2", "endBin2", "distance"}
            return [c for c in self.intervals.columns if c in base]
        base = {
            c[:-1]
            for c in columns
            if c and c[-1] in "12" and c[:-1] in self.intervals.columns
        }
        base |= {"stBin", "endBin"}
        return [c for c in self.intervals.columns if c in base]

    def _finalize(self, frame, control, groupby, modify_func, rng):
        frame = self.control_regions(frame, self.nshifts if control else 0, rng=rng)
        if modify_func is not None:
            frame = modify_func(frame)
        frame = assign_groups(frame, groupby)
        return frame

    def _batches_bedpe(self, region1, region2, control, groupby,
                       modify_func, use=None):
        if self.trans and region2 is not None and region1[0] != region2[0]:
            iv = self.filter_bedpe_trans_pairs(region1, region2)
        else:
            iv = self.filter_bedpe_region(region1)
        if use is not None:
            iv = iv[use]
        rng = self._rng((region1, region2))
        for lo in range(0, max(len(iv), 1), self.chunk_size):
            chunk = iv.iloc[lo : lo + self.chunk_size]
            if len(chunk) == 0:
                return
            yield self._finalize(
                chunk.reset_index(drop=True), control, groupby, modify_func, rng
            )

    def _batches_local(self, region1, control, groupby, modify_func,
                       use=None):
        iv = self.filter_bed_region(region1)
        if len(iv) == 0:
            return
        if use is not None:
            iv = iv[use]
        merged = pd.merge(
            iv, iv, left_index=True, right_index=True, suffixes=["1", "2"]
        )
        rng = self._rng((region1, None))
        for lo in range(0, len(merged), self.chunk_size):
            yield self._finalize(
                merged.iloc[lo : lo + self.chunk_size].reset_index(drop=True),
                control,
                groupby,
                modify_func,
                rng,
            )

    def _batches_trans_bed(self, region1, region2, control, groupby,
                           modify_func, use=None):
        left = self.filter_bed_region(region1)
        right = self.filter_bed_region(region2)
        if len(left) == 0 or len(right) == 0:
            return
        rng = self._rng((region1, region2))
        # full cartesian product, chunked over the left side; built from
        # raw-array takes of repeat/tile indices (pandas cross-merge
        # re-consolidates and re-builds Arrow string buffers per chunk)
        nr = len(right)
        rows_per_chunk = max(1, self.chunk_size // max(nr, 1))
        cols = list(left.columns) if use is None else use

        def raw(df):
            return {
                c: (
                    df[c].to_numpy()
                    if isinstance(df[c].dtype, np.dtype)
                    else df[c].array
                )
                for c in cols
            }

        larrs, rarrs = raw(left), raw(right)
        for lo in range(0, len(left), rows_per_chunk):
            nl = min(lo + rows_per_chunk, len(left)) - lo
            li = np.repeat(np.arange(lo, lo + nl), nr)
            ri = np.tile(np.arange(nr), nl)
            data = {c + "1": larrs[c].take(li) for c in cols}
            data.update({c + "2": rarrs[c].take(ri) for c in cols})
            yield self._finalize(
                pd.DataFrame(data), control, groupby, modify_func, rng
            )

    # eager pair enumeration above this many estimated pairs would hold
    # GBs of index arrays; the lazy k-sweep streams chunks with O(chunk)
    # memory instead (the reference streams pairs one at a time and claims
    # "no limit", README.md:30 — this is the array-batch analog)
    LAZY_PAIR_THRESHOLD = 32_000_000

    def _count_cis_pairs(self, centers):
        """Exact in-band pair count for SORTED centers, O(n log n)."""
        n = len(centers)
        maxd = float(self.maxdist) if np.isfinite(self.maxdist) else np.inf
        idx = np.arange(n)
        if np.isfinite(maxd):
            hi = np.searchsorted(centers, centers + maxd, side="right")
        else:
            hi = np.full(n, n)
        lo = np.searchsorted(centers, centers + float(self.mindist),
                             side="left")
        return int(np.maximum(hi - np.maximum(lo, idx + 1), 0).sum())

    def _iter_cis_pair_chunks(self, centers):
        """Yield (li, ri) pair-index chunks of exactly ``chunk_size`` (last
        partial) in the canonical k-superdiagonal order. Small streams come
        from the eager enumeration (native C++ sweep); large ones stream
        lazily per k-diagonal with bounded memory. Both produce the
        IDENTICAL global sequence and therefore identical chunk boundaries
        — the keyed control RNG draws per chunk, so boundaries are part of
        the reproducibility contract."""
        n = len(centers)
        centers_sorted = bool(np.all(np.diff(centers) >= 0))
        if (
            not centers_sorted
            or self._count_cis_pairs(centers) <= self.LAZY_PAIR_THRESHOLD
        ):
            li, ri = self._enumerate_cis_pairs(centers)
            for lo in range(0, len(li), self.chunk_size):
                yield (
                    li[lo : lo + self.chunk_size],
                    ri[lo : lo + self.chunk_size],
                )
            return
        maxd = float(self.maxdist) if np.isfinite(self.maxdist) else 1e300
        buf_l, buf_r, buffered = [], [], 0
        for k in range(1, n):
            li = np.arange(0, n - k)
            d = centers[li + k] - centers[li]
            if d.min() > maxd:
                break
            keep = (self.mindist <= np.abs(d)) & (np.abs(d) <= maxd)
            if keep.any():
                buf_l.append(li[keep])
                buf_r.append(li[keep] + k)
                buffered += int(keep.sum())
            while buffered >= self.chunk_size:
                ls = np.concatenate(buf_l)
                rs = np.concatenate(buf_r)
                yield ls[: self.chunk_size], rs[: self.chunk_size]
                buf_l = [ls[self.chunk_size :]]
                buf_r = [rs[self.chunk_size :]]
                buffered = len(buf_l[0])
        if buffered:
            yield np.concatenate(buf_l), np.concatenate(buf_r)

    def _enumerate_cis_pairs(self, centers):
        """All (li, ri) index pairs with |center[ri]-center[li]| in the
        distance band, in k-superdiagonal order with early termination on
        sorted centers — the C++ sweep (native/_ingest.cpp::enumerate_pairs)
        when built, a vectorized numpy sweep otherwise. Both produce the
        identical pair sequence, so chunk boundaries (and therefore keyed-RNG
        control draws) do not depend on which one ran."""
        n = len(centers)
        centers_sorted = bool(np.all(np.diff(centers) >= 0))
        maxd = float(self.maxdist) if np.isfinite(self.maxdist) else 1e300
        if _native_enumerate_pairs is not None and centers_sorted:
            return _native_enumerate_pairs(
                centers.astype(np.float64), float(self.mindist), maxd
            )
        parts_l, parts_r = [], []
        for k in range(1, n):
            li = np.arange(0, n - k)
            d = centers[li + k] - centers[li]
            if centers_sorted and d.min() > maxd:
                break
            keep = (self.mindist <= np.abs(d)) & (np.abs(d) <= maxd)
            if keep.any():
                parts_l.append(li[keep])
                parts_r.append(li[keep] + k)
        if not parts_l:
            empty = np.array([], dtype=np.int64)
            return empty, empty
        return np.concatenate(parts_l), np.concatenate(parts_r)

    def _batches_cis_bed(self, region1, control, groupby, modify_func,
                         use=None):
        iv = self.filter_bed_region(region1)
        n = len(iv)
        if n < 2:
            return
        cols = list(iv.columns) if use is None else use
        centers = iv["center"].values
        rng = self._rng((region1, None))
        # raw-array view per column ONCE: Series.take drags index machinery
        # through every column, and round-tripping Arrow-backed string
        # columns through numpy object arrays makes pandas re-build the
        # Arrow buffers per chunk (~1s/M rows each at 20+ columns)
        arrs = {
            c: (
                iv[c].to_numpy()
                if isinstance(iv[c].dtype, np.dtype)
                else iv[c].array
            )
            for c in cols
        }
        for ls, rs in self._iter_cis_pair_chunks(centers):
            data = {c + "1": arrs[c].take(ls) for c in cols}
            data.update({c + "2": arrs[c].take(rs) for c in cols})
            data["distance"] = centers[rs] - centers[ls]
            combo = pd.DataFrame(data)
            yield self._finalize(combo, control, groupby, modify_func, rng)
