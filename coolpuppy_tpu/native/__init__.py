"""C++ acceleration for host-side ingest (COO→tile scatter, pair
enumeration), bound via ctypes. The library is built from
``_ingest.cpp`` on first import (``build.ensure_built``, or
``python -m coolpuppy_tpu.native.build``); without a compiler the callers
fall back to numpy."""

import ctypes
import logging
import os
import subprocess

import numpy as np

from .build import OUT as _SO, ensure_built

# Leave one core for the engine's main thread: the OpenMP scatter runs on
# the staging worker WHILE the main thread generates coordinates, and
# using every core oversubscribes the host. Explicit OMP_NUM_THREADS wins
# if the user set one.
if "OMP_NUM_THREADS" not in os.environ:
    os.environ["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 2) - 1))

tile_scatter = None
tile_scatter_wtri = None
enumerate_pairs = None

try:
    _built = ensure_built()
except (OSError, subprocess.CalledProcessError) as _err:
    logging.getLogger("coolpuppy_tpu").warning(
        "native ingest library not built (%s); using numpy", _err
    )
    _built = False

if _built:
    try:
        _lib = ctypes.CDLL(_SO)
        _lib.tile_scatter_wtri.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib.tile_scatter.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        for _name in ("tile_scatter_i32f32", "tile_scatter_i32f64"):
            getattr(_lib, _name).argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(
                    ctypes.c_float if _name.endswith("f32") else ctypes.c_double
                ),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float),
            ]
        _lib.enumerate_pairs.restype = ctypes.c_int64
        _lib.enumerate_pairs.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]

        def tile_scatter(rows, cols, vals, tile_map, B, K, nc):  # noqa: F811
            """COO -> [K+1, B, B] f32 tile stack (see ops/tiles.py). Picks
            the dtype-matched native entry so scipy's int32/float32 COO
            arrays scatter without conversion copies."""
            rows = np.ascontiguousarray(rows)
            cols = np.ascontiguousarray(cols)
            vals = np.ascontiguousarray(vals)
            tm = np.ascontiguousarray(tile_map, np.int32)
            out = np.zeros((K + 1, B, B), np.float32)
            if rows.dtype == np.int32 and cols.dtype == np.int32:
                if vals.dtype == np.float32:
                    fn, vt = _lib.tile_scatter_i32f32, ctypes.c_float
                else:
                    vals = np.ascontiguousarray(vals, np.float64)
                    fn, vt = _lib.tile_scatter_i32f64, ctypes.c_double
                it = ctypes.c_int32
            else:
                rows = np.ascontiguousarray(rows, np.int64)
                cols = np.ascontiguousarray(cols, np.int64)
                vals = np.ascontiguousarray(vals, np.float64)
                fn, vt, it = _lib.tile_scatter, ctypes.c_double, ctypes.c_int64
            fn(
                rows.ctypes.data_as(ctypes.POINTER(it)),
                cols.ctypes.data_as(ctypes.POINTER(it)),
                vals.ctypes.data_as(ctypes.POINTER(vt)),
                ctypes.c_int64(len(rows)),
                tm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ctypes.c_int64(tm.shape[1]),
                ctypes.c_int64(B),
                ctypes.c_int64(K),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            return out

        def tile_scatter_wtri(  # noqa: F811
            rows, cols, vals, lo1, lo2, n1, n2, weights, tile_map, B, K,
            mirror,
        ):
            """Stored-triangle COO -> [K+1, B, B] f32 tile stack, folding in
            balancing weights and the symmetric mirror (see _ingest.cpp)."""
            rows = np.ascontiguousarray(rows, np.int64)
            cols = np.ascontiguousarray(cols, np.int64)
            vals = np.ascontiguousarray(vals, np.float32)
            tm = np.ascontiguousarray(tile_map, np.int32)
            if weights is not None:
                weights = np.ascontiguousarray(weights, np.float32)
                wptr = weights.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            else:
                wptr = ctypes.POINTER(ctypes.c_float)()
            out = np.zeros((K + 1, B, B), np.float32)
            _lib.tile_scatter_wtri(
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.c_int64(len(rows)),
                ctypes.c_int64(lo1),
                ctypes.c_int64(lo2),
                ctypes.c_int64(n1),
                ctypes.c_int64(n2),
                wptr,
                tm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ctypes.c_int64(tm.shape[1]),
                ctypes.c_int64(B),
                ctypes.c_int64(K),
                ctypes.c_int32(1 if mirror else 0),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            return out

        def enumerate_pairs(centers, mindist, maxdist, cap=None):  # noqa: F811
            """All sorted-center pairs with distance in [mindist, maxdist]."""
            centers = np.ascontiguousarray(centers, np.float64)
            n = len(centers)
            if cap is None:
                cap = max(1024, n * 64)
            while True:
                out_i = np.empty(cap, np.int64)
                out_j = np.empty(cap, np.int64)
                cnt = _lib.enumerate_pairs(
                    centers.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    ctypes.c_int64(n),
                    ctypes.c_double(mindist),
                    ctypes.c_double(float(maxdist)),
                    out_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    out_j.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    ctypes.c_int64(cap),
                )
                if cnt >= 0:
                    return out_i[:cnt], out_j[:cnt]
                cap *= 4

    except Exception:  # pragma: no cover
        tile_scatter = None
        tile_scatter_wtri = None
        enumerate_pairs = None
