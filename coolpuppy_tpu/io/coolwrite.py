"""Writer for `.cool` (HDF5) files, and the same layout held in memory.

The reference depends on binary test coolers that are not redistributable
(reference .MISSING_LARGE_BLOBS); this writer lets tests synthesize compatible
fixtures and lets users convert matrices. Schema follows the cooler v3 layout
(chroms/bins/pixels/indexes + attrs) that `io/cool.py` reads.
``cool_layout`` builds that layout as a ``MemoryCool``, which ``Cooler``
reads like a file on hosts without h5py.
"""

from __future__ import annotations

import numpy as np


class MemoryCool:
    """A cooler's groups, datasets and attrs held in memory: ``grp[path]``
    returns a dataset (numpy array) or a sub-group, ``keys()`` lists a
    group's members in h5py's (sorted) order."""

    def __init__(self, datasets, attrs=None):
        self._data = datasets
        self.attrs = dict(attrs or {})

    def __getitem__(self, key):
        if key in self._data:
            return self._data[key]
        prefix = key.rstrip("/") + "/"
        sub = {
            k[len(prefix):]: v for k, v in self._data.items()
            if k.startswith(prefix)
        }
        if not sub:
            raise KeyError(key)
        return MemoryCool(sub)

    def keys(self):
        return sorted({k.split("/")[0] for k in self._data})


def cool_layout(
    chromsizes,
    binsize,
    pixels,
    weights=None,
    extra_bin_cols=None,
    assembly="unknown",
):
    """The cooler v3 layout of a matrix as a ``MemoryCool``.

    Parameters
    ----------
    chromsizes : dict chrom -> length (bp), in desired chromosome order.
    binsize : int
    pixels : (bin1_id, bin2_id, count) arrays in *global* bin ids, upper
        triangle (bin1_id <= bin2_id). Will be sorted (bin1, bin2).
    weights : optional per-bin balancing weight array (NaN = bad bin).
    extra_bin_cols : optional dict of name -> per-bin array (e.g. coverage).
    """
    chroms = list(chromsizes.keys())
    lengths = np.array([chromsizes[c] for c in chroms], dtype=np.int64)
    n_bins_per_chrom = np.ceil(lengths / binsize).astype(np.int64)
    chrom_offset = np.concatenate([[0], np.cumsum(n_bins_per_chrom)])
    n_bins = int(chrom_offset[-1])

    chrom_ids = np.repeat(np.arange(len(chroms)), n_bins_per_chrom)
    starts = np.concatenate(
        [np.arange(n) * binsize for n in n_bins_per_chrom]
    ).astype(np.int64)
    ends = np.minimum(starts + binsize, lengths[chrom_ids]).astype(np.int64)

    bin1, bin2, count = (np.asarray(a) for a in pixels)
    assert np.all(bin1 <= bin2), "pixels must be upper-triangle (bin1 <= bin2)"
    order = np.lexsort((bin2, bin1))
    bin1, bin2, count = bin1[order], bin2[order], count[order]
    nnz = len(bin1)

    bin1_offset = np.searchsorted(bin1, np.arange(n_bins + 1)).astype(np.int64)

    attrs = {
        "format": "HDF5::Cooler",
        "format-version": 3,
        "bin-type": "fixed",
        "bin-size": int(binsize),
        "storage-mode": "symmetric-upper",
        "nchroms": len(chroms),
        "nbins": n_bins,
        "nnz": nnz,
        "genome-assembly": assembly,
        "generated-by": "coolpuppy-tpu",
    }
    data = {
        "chroms/name": np.array(chroms, dtype=object),
        "chroms/length": lengths,
        "bins/chrom": chrom_ids.astype(np.int32),
        "bins/start": starts,
        "bins/end": ends,
    }
    if weights is not None:
        data["bins/weight"] = np.asarray(weights, dtype=np.float64)
    for name, arr in (extra_bin_cols or {}).items():
        data[f"bins/{name}"] = np.asarray(arr)
    data["pixels/bin1_id"] = bin1.astype(np.int64)
    data["pixels/bin2_id"] = bin2.astype(np.int64)
    if np.issubdtype(np.asarray(count).dtype, np.integer):
        data["pixels/count"] = count.astype(np.int32)
    else:
        data["pixels/count"] = count.astype(np.float64)
    data["indexes/chrom_offset"] = chrom_offset
    data["indexes/bin1_offset"] = bin1_offset
    return MemoryCool(data, attrs)


def write_cool(path, chromsizes, binsize, pixels, weights=None,
               extra_bin_cols=None, group="/", assembly="unknown"):
    """Write a .cool file (arguments as in ``cool_layout``)."""
    import h5py

    layout = cool_layout(
        chromsizes, binsize, pixels, weights=weights,
        extra_bin_cols=extra_bin_cols, assembly=assembly,
    )
    with h5py.File(path, "w") as f:
        grp = f if group in ("/", "") else f.create_group(group)
        grp.attrs.update(layout.attrs)
        for key, arr in layout._data.items():
            if arr.dtype == object:
                arr = arr.astype(h5py.string_dtype())
            grp.create_dataset(key, data=arr)
    return path
