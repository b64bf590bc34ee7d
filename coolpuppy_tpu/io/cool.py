"""Minimal self-contained `.cool` (HDF5) reader.

Re-owns the slice of the cooler API the reference uses (reference
coolpup.py:1024–1098: ``clr.matrix(sparse=True, balance=...).fetch``,
``clr.bins()[col].fetch``, ``clr.extent``, ``clr.offset``; CLI.py:406), built
directly on h5py/libhdf5. Range queries use the ``indexes/bin1_offset`` table so
a region fetch reads one contiguous pixel slab per row-span.

Supports cooler URI syntax ``path::group`` (e.g. ``x.mcool::/resolutions/10000``),
and an in-memory cooler (``io.coolwrite.cool_layout``) on hosts without h5py.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import pandas as pd
from scipy import sparse as sp

from .coolwrite import MemoryCool


@dataclass
class PixelSlab:
    """Stored-triangle pixels of a region fetch, before mirroring/balancing —
    the zero-copy handle the tile scatter consumes. ``rows``/``cols`` are
    GLOBAL bin ids; the logical rectangle is rows in [lo1, lo1+shape[0]),
    cols in [lo2, lo2+shape[1]). ``mirror`` means the symmetric transpose of
    every off-diagonal pixel also belongs to the rectangle (cis same-extent
    fetches — the mirror is applied by the consumer, never materialized).
    ``weights`` is the GLOBAL per-bin balancing vector with NaNs cleaned to 0
    (bad-bin products -> 0, masked downstream like reference
    coolpup.py:1122–1123), or None for unbalanced."""

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray  # float32
    lo1: int
    lo2: int
    shape: tuple
    mirror: bool
    weights: np.ndarray | None

    @property
    def nnz(self):
        return len(self.rows)


def parse_cooler_uri(uri):
    path, _, group = str(uri).partition("::")
    return path, (group if group.startswith("/") else "/" + group) if group else "/"


class _BinsAccessor:
    """Mimics ``clr.bins()`` enough for ``bins()[col].fetch(region)`` and
    ``col in clr.bins().columns`` (reference coolpup.py:950–957, 1081–1098)."""

    def __init__(self, clr):
        self._clr = clr

    @property
    def columns(self):
        return self._clr._bin_columns()

    def __getitem__(self, col):
        return _BinsColumn(self._clr, col)

    def fetch(self, region):
        clr = self._clr
        lo, hi = clr.extent(region)
        return clr.bins_df().iloc[lo:hi]


class _BinsColumn:
    def __init__(self, clr, col):
        self._clr = clr
        self._col = col

    def fetch(self, region):
        lo, hi = self._clr.extent(region)
        return self._clr.bins_df()[self._col].iloc[lo:hi]


class _MatrixSelector:
    def __init__(self, clr, balance, sparse_out):
        self._clr = clr
        self._balance = balance
        self._sparse = sparse_out

    def fetch(self, region1, region2=None):
        coo = self._clr.fetch_coo(region1, region2, balance=self._balance)
        if self._sparse:
            return coo
        return np.asarray(coo.todense())


class Cooler:
    def __init__(self, uri):
        """``uri``: a ``.cool`` path (``path::group`` allowed) or a
        ``MemoryCool``."""
        self._memory = uri if isinstance(uri, MemoryCool) else None
        self.uri = "<memory>" if self._memory is not None else str(uri)
        self.filename, self.group = parse_cooler_uri(self.uri)
        self._lock = threading.Lock()
        self._extra_bin_cols = {}
        with self._open() as grp:
            self.binsize = int(grp.attrs["bin-size"])
            chrom_names = grp["chroms/name"][:]
            self.chromnames = [
                c.decode() if isinstance(c, bytes) else str(c) for c in chrom_names
            ]
            lengths = grp["chroms/length"][:].astype(np.int64)
            self.chromsizes = dict(zip(self.chromnames, lengths))
            self._chrom_offset = grp["indexes/chrom_offset"][:].astype(np.int64)
            self.n_bins = int(grp["bins/start"].shape[0])
            self.n_pixels = int(grp["pixels/bin1_id"].shape[0])
        self._bins_df = None
        self._bin1_offset = None
        self._n_bins = self.n_bins
        self._weights_clean_cache = {}

    # -- low-level ---------------------------------------------------------

    @contextmanager
    def _open(self):
        if self._memory is not None:
            yield self._memory
            return
        import h5py

        with h5py.File(self.filename, "r") as f:
            yield f[self.group]

    def _bin_columns(self):
        with self._lock, self._open() as grp:
            cols = list(grp["bins"].keys())
        return pd.Index(cols + list(self._extra_bin_cols.keys()))

    def bins_df(self):
        """Full bins table as a DataFrame (chrom as string)."""
        if self._bins_df is None:
            with self._lock, self._open() as grp:
                bins = {}
                for col in grp["bins"].keys():
                    arr = grp["bins"][col][:]
                    bins[col] = arr
                chrom = bins["chrom"]
                if chrom.dtype.kind in "iu":
                    chrom = np.asarray(self.chromnames, dtype=object)[chrom]
                else:
                    chrom = np.array(
                        [c.decode() if isinstance(c, bytes) else str(c) for c in chrom],
                        dtype=object,
                    )
                bins["chrom"] = chrom
                self._bins_df = pd.DataFrame(bins)
            for col, arr in self._extra_bin_cols.items():
                self._bins_df[col] = arr
        return self._bins_df

    def store_bin_column(self, name, values):
        """Attach a computed per-bin column (e.g. coverage) in memory.

        The reference writes coverage back into the cooler file
        (coolpup.py:959–963 via cooltools ``store=True``); our source files may
        be read-only so computed columns live on the object.
        """
        values = np.asarray(values)
        assert values.shape == (self.n_bins,)
        self._extra_bin_cols[name] = values
        if self._bins_df is not None:
            self._bins_df[name] = values

    def bin1_offset(self):
        if self._bin1_offset is None:
            with self._lock, self._open() as grp:
                self._bin1_offset = grp["indexes/bin1_offset"][:].astype(np.int64)
        return self._bin1_offset

    # -- region arithmetic -------------------------------------------------

    def _parse_region(self, region):
        """Accept (chrom, start, end) tuples, pandas rows, or 'chrom' /
        'chrom:start-end' strings. Returns (chrom, start, end)."""
        if isinstance(region, pd.Series):
            return (
                str(region.iloc[0]),
                int(region.iloc[1]),
                int(region.iloc[2]),
            )
        if isinstance(region, str):
            if ":" in region:
                chrom, _, rng = region.partition(":")
                start, _, end = rng.partition("-")
                return chrom, int(start.replace(",", "")), int(end.replace(",", ""))
            return region, 0, int(self.chromsizes[region])
        chrom, start, end = region[0], region[1], region[2]
        return str(chrom), int(start), int(end)

    def offset(self, chrom):
        """Global bin index of the first bin of ``chrom``
        (cooler ``clr.offset``, used at reference coolpup.py:924)."""
        chrom, start, _ = self._parse_region(chrom)
        cix = self.chromnames.index(chrom)
        return int(self._chrom_offset[cix] + start // self.binsize)

    def extent(self, region):
        """(lo, hi) global bin range of a region (cooler ``clr.extent``,
        used at reference coolpup.py:923)."""
        chrom, start, end = self._parse_region(region)
        cix = self.chromnames.index(chrom)
        off = self._chrom_offset[cix]
        lo = off + start // self.binsize
        hi = off + int(np.ceil(end / self.binsize))
        return int(lo), int(hi)

    # -- pixel fetch -------------------------------------------------------

    def _fetch_rect_raw(self, lo1, hi1, lo2, hi2, dtype=np.float32):
        """Stored (upper-triangle) pixels with bin1 in [lo1,hi1), bin2 in
        [lo2,hi2). One contiguous HDF5 slab read over the row span; counts
        are converted to ``dtype`` at read time (no post-hoc astype pass).
        float32 is the hot tile-scatter path; the exact compat path
        (fetch_coo / expected) reads float64 so counts >= 2**24 stay exact."""
        b1off = self.bin1_offset()
        p_lo, p_hi = int(b1off[lo1]), int(b1off[hi1])
        if p_hi <= p_lo:
            empty = np.array([], dtype=np.int64)
            return empty, empty, np.array([], dtype=dtype)
        with self._lock, self._open() as grp:
            bin1 = grp["pixels/bin1_id"][p_lo:p_hi]
            bin2 = grp["pixels/bin2_id"][p_lo:p_hi]
            count = grp["pixels/count"][p_lo:p_hi].astype(dtype, copy=False)
        bin1 = bin1.astype(np.int64, copy=False)
        bin2 = bin2.astype(np.int64, copy=False)
        if lo2 <= 0 and hi2 >= self._n_bins:
            return bin1, bin2, count  # full column span: nothing to filter
        mask = (bin2 >= lo2) & (bin2 < hi2)
        return bin1[mask], bin2[mask], count[mask]

    def _clean_weights(self, balance):
        """Global per-bin balancing weights with NaN -> 0 (cached; the
        NaN-cleaning the old path did per-pixel over the whole fetch)."""
        balance = "weight" if balance is True else balance
        w = self._weights_clean_cache.get(balance)
        if w is None:
            w = np.nan_to_num(
                self.bins_df()[balance].values.astype(np.float32)
            )
            self._weights_clean_cache[balance] = w
        return w

    def fetch_slab(self, region1, region2=None, balance="weight", dtype=np.float32):
        """Stored-triangle pixels of the query rectangle as a PixelSlab —
        the fast path behind ``fetch_coo``/the tile scatter. A cis
        same-extent query is ONE contiguous HDF5 read (mirror deferred to
        the consumer); distinct extents read both row spans like cooler."""
        lo1, hi1 = self.extent(region1)
        lo2, hi2 = self.extent(region2 if region2 is not None else region1)
        weights = self._clean_weights(balance) if balance else None

        if (lo1, hi1) == (lo2, hi2):
            rows, cols, vals = self._fetch_rect_raw(lo1, hi1, lo2, hi2, dtype)
            mirror = True
        else:
            r1, c1, v1 = self._fetch_rect_raw(lo1, hi1, lo2, hi2, dtype)
            # transpose of stored pixels landing in the rectangle the other
            # way; exclude the stored diagonal to avoid double counting
            r2, c2, v2 = self._fetch_rect_raw(lo2, hi2, lo1, hi1, dtype)
            keep = r2 != c2
            rows = np.concatenate([r1, c2[keep]])
            cols = np.concatenate([c1, r2[keep]])
            vals = np.concatenate([v1, v2[keep]])
            mirror = False

        return PixelSlab(
            rows=rows,
            cols=cols,
            vals=vals,
            lo1=lo1,
            lo2=lo2,
            shape=(hi1 - lo1, hi2 - lo2),
            mirror=mirror,
            weights=weights,
        )

    def fetch_coo(self, region1, region2=None, balance="weight"):
        """Symmetric-logical sparse COO of the query rectangle, optionally
        balanced — the counterpart of
        ``clr.matrix(sparse=True, balance=...).fetch(r1, r2)``
        (reference coolpup.py:1053–1057). Bad-bin (NaN-weight) products are
        mapped to 0; bad bins are masked downstream exactly like the
        reference NaNs full rows/cols (coolpup.py:1122–1123)."""
        # float64 at the HDF5 layer keeps cooler-identical numerics on the
        # compat API, incl. raw counts >= 2**24 (the hot slab->tile path
        # stays float32)
        slab = self.fetch_slab(region1, region2, balance=balance, dtype=np.float64)
        rows, cols, vals = slab.rows, slab.cols, slab.vals
        if slab.weights is not None:
            balance = "weight" if balance is True else balance
            w = np.nan_to_num(
                self.bins_df()[balance].values.astype(np.float64)
            )
            vals = vals * w[rows] * w[cols]
        if slab.mirror:
            off = rows != cols
            rows, cols, vals = (
                np.concatenate([rows, cols[off]]),
                np.concatenate([cols, rows[off]]),
                np.concatenate([vals, vals[off]]),
            )
        return sp.coo_matrix(
            (vals, (rows - slab.lo1, cols - slab.lo2)), shape=slab.shape
        )

    def matrix(self, sparse=False, balance="weight"):
        return _MatrixSelector(self, balance=balance, sparse_out=sparse)

    def bins(self):
        return _BinsAccessor(self)

    def bad_bin_mask(self, region, weight_name="weight"):
        """Boolean per-bin mask of NaN-weight (unbalanceable) bins in region —
        the ``isnan1``/``isnan2`` vectors of reference coolpup.py:1081–1094."""
        lo, hi = self.extent(region)
        if not weight_name:
            return np.zeros(hi - lo, dtype=bool)
        w = self.bins_df()[weight_name].values[lo:hi].astype(np.float64)
        return np.isnan(w)

    def pixels_chunk(self, start, stop):
        """Raw pixel slab [start, stop) as (bin1, bin2, count) — building block
        for whole-genome streaming (coverage / expected computation)."""
        with self._lock, self._open() as grp:
            return (
                grp["pixels/bin1_id"][start:stop].astype(np.int64),
                grp["pixels/bin2_id"][start:stop].astype(np.int64),
                grp["pixels/count"][start:stop].astype(np.float64),
            )
