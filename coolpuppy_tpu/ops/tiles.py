"""Block-sparse tile stack: the device-resident matrix representation.

Replaces the scipy CSR whose per-snip window slicing is the reference's hot
inner loop (reference coolpup.py:1077, 1115–1121). The host scatters COO
pixels into dense B×B tiles — only tiles touched by at least one window are
materialized — plus a dense (tile-row, tile-col) → stack-index lookup whose
entry 0 is a shared all-zero tile. With B ≥ window size every window straddles
at most 2×2 tiles, so the device gather is pure integer indexing +
dynamic_slice with static shapes (see ops/gather.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

try:  # optional native scatter (coolpuppy_tpu/native)
    from ..native import tile_scatter as _native_tile_scatter
    from ..native import tile_scatter_wtri as _native_tile_scatter_wtri
except Exception:  # pragma: no cover - native ext is optional
    _native_tile_scatter = None
    _native_tile_scatter_wtri = None


@dataclass
class TileStack:
    tiles: np.ndarray  # [K, B, B] float32; tiles[0] is all zeros
    tile_map: np.ndarray  # [nr+1, nc+1] int32 -> stack index (0 = empty)
    B: int
    shape: tuple  # logical (n1, n2) of the region matrix

    @property
    def nbytes(self):
        return self.tiles.nbytes + self.tile_map.nbytes

    @property
    def n_tiles(self):
        return self.tiles.shape[0] - 1


@dataclass
class SymTileStack:
    """Upper-triangle tile storage for SYMMETRIC (cis) regions: only tiles
    with tile_row <= tile_col are scattered and uploaded; the device
    materializes the full stack as ``full[k] = upper[src[k]]`` (transposed
    where ``flip[k]``, symmetrized where ``diag[k]`` and the scatter held
    only the stored upper half). Halves both the host scatter work and the
    host->device tile payload."""

    upper: np.ndarray  # [Ku+1, B, B] float32; slot 0 all zeros
    tile_map: np.ndarray  # [nr+1, nc+1] -> FULL stack index (0 = empty)
    src: np.ndarray  # [K+1] full slot -> upper slot
    flip: np.ndarray  # [K+1] bool: transpose upper[src]
    diag: np.ndarray  # [K+1] bool: tile_row == tile_col
    diag_full: bool  # diagonal tiles already hold both halves
    B: int
    shape: tuple

    @property
    def n_tiles(self):
        return len(self.src) - 1

    def expand_host(self):
        """Materialize the full [K+1, B, B] stack on the host (tests /
        host-side consumers)."""
        g = self.upper[self.src]
        gt = np.transpose(g, (0, 2, 1))
        full = np.where(self.flip[:, None, None], gt, g)
        if not self.diag_full:
            eye = np.eye(self.B, dtype=g.dtype)
            sym = g + gt - g * eye
            full = np.where(self.diag[:, None, None], sym, full)
        return full.astype(np.float32)

def cast_tiles_f16(tiles, mode):
    """Host->device WIRE compression for a raw tile payload: cast to f16
    with a power-of-2 scale placing the max |value| near 2^13 (pow2
    scaling only adjusts the exponent, so it is exact in both directions
    and keeps ~9 decades of dynamic range in the normal-f16 window).

    ``mode``:
      - falsy      -> None (ship f32)
      - ``"exact"`` -> f16 ONLY when the scaled round-trip is bit-exact —
        always true for raw integer Hi-C counts <= 2048 (f16 has an
        11-bit significand), and verified here for everything else; on
        any mismatch the payload ships f32.
      - ``"lossy"`` -> f16 with <= 2^-11 (~4.9e-4) relative error per
        value (balanced / OOE-divided magnitudes; the engine gates this
        on modes whose values are O(1)).

    Returns ``(wire_f16, inv_scale_f32)`` or None (use f32). The device
    side multiplies by ``inv_scale`` after upconverting: half the bytes of
    the f32 tile upload (the reference never ships tiles — it slices its
    CSR locally, reference coolpup.py:1053–1057)."""
    if not mode:
        return None
    if tiles.size == 0:
        return tiles.astype(np.float16), np.float32(1.0)
    with np.errstate(invalid="ignore"):
        amax = float(np.nanmax(np.abs(tiles)))
    if np.isinf(amax):
        return None
    if not np.isfinite(amax) or amax == 0.0:  # all-zero / all-NaN
        return tiles.astype(np.float16), np.float32(1.0)
    scale = np.float32(2.0 ** (13 - int(np.ceil(np.log2(amax) + 1e-12))))
    wire = (tiles * scale).astype(np.float16)
    inv = np.float32(1.0 / scale)
    if mode == "exact":
        rt = wire.astype(np.float32) * inv
        if not np.array_equal(rt, tiles, equal_nan=True):
            return None
    return wire, inv


@lru_cache(maxsize=8)
def _make_expand_sym_fn(B, diag_full):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def f(up, src, flip, diag, inv):
        # f16 wire payloads upconvert + unscale here (inv is the pow2
        # inverse scale from cast_tiles_f16; 1.0 for f32 payloads)
        g = up[src].astype(jnp.float32) * inv
        gt = jnp.transpose(g, (0, 2, 1))
        full = jnp.where(flip[:, None, None], gt, g)
        if not diag_full:
            eye = jnp.eye(B, dtype=g.dtype)
            sym = g + gt - g * eye
            full = jnp.where(diag[:, None, None], sym, full)
        return full

    return f


def expand_sym_device(sym: SymTileStack, k_pad=None, f16_mode=False):
    """Upload the upper tiles and materialize the FULL raw stack on device
    (one [K_pad, B, B] device array; K_pad pow2 so downstream kernel
    signatures stay pinned). ``f16_mode`` ships the tiles as scaled f16
    when safe (see cast_tiles_f16)."""
    import jax

    from .gather import pad_pow2

    K1 = len(sym.src)
    if k_pad is None:
        k_pad = max(64, 1 << int(np.ceil(np.log2(max(1, K1)))))
    cast = cast_tiles_f16(sym.upper, f16_mode)
    if cast is not None:
        upper_w, inv = cast
    else:
        upper_w, inv = sym.upper, np.float32(1.0)
    up_dev = jax.device_put(pad_pow2(upper_w, axis=0))
    src = np.zeros(k_pad, np.int32)
    src[:K1] = sym.src
    flip = np.zeros(k_pad, bool)
    flip[:K1] = sym.flip
    diag = np.zeros(k_pad, bool)
    diag[:K1] = sym.diag
    f = _make_expand_sym_fn(sym.B, bool(sym.diag_full))
    return f(up_dev, src, flip, diag, inv)


def _sym_maps(want, nr, nc):
    """Build the full tile_map plus (src, flip, diag) expansion metadata and
    the upper scatter map for an upper-triangle build."""
    tr, tc = want // nc, want % nc
    K = len(want)
    tile_map = np.zeros((nr + 1, nc + 1), dtype=np.int32)
    tile_map[tr, tc] = np.arange(1, K + 1, dtype=np.int32)

    lo = np.minimum(tr, tc)
    hi = np.maximum(tr, tc)
    ukey = lo.astype(np.int64) * nc + hi
    uniq, inv = np.unique(ukey, return_inverse=True)
    Ku = len(uniq)
    utile_map = np.zeros((nr + 1, nc + 1), dtype=np.int32)
    utile_map[uniq // nc, uniq % nc] = np.arange(1, Ku + 1, dtype=np.int32)

    src = np.zeros(K + 1, np.int32)
    src[1:] = inv + 1
    flip = np.zeros(K + 1, bool)
    flip[1:] = tr > tc
    diag = np.zeros(K + 1, bool)
    diag[1:] = tr == tc
    return tile_map, utile_map, src, flip, diag, Ku


def touched_tiles(r1, r2, window1, window2, B, shape):
    """Set of (tile_row, tile_col) touched by windows starting at (r1, r2)
    with heights window1 and widths window2 (arrays or scalars)."""
    n1, n2 = shape
    nr, nc = -(-n1 // B), -(-n2 // B)
    w1 = np.broadcast_to(np.asarray(window1), np.shape(r1))
    w2 = np.broadcast_to(np.asarray(window2), np.shape(r2))
    t1a = np.asarray(r1) // B
    t1b = (np.asarray(r1) + w1 - 1) // B
    t2a = np.asarray(r2) // B
    t2b = (np.asarray(r2) + w2 - 1) // B
    # windows span at most 2 tiles per axis (B >= max window): flag the four
    # corner tiles per window in a bitmap (no per-corner unique/set churn)
    flags = np.zeros(nr * nc, dtype=bool)
    for rr, cc in (
        (t1a, t2a),
        (t1a, t2b),
        (t1b, t2a),
        (t1b, t2b),
    ):
        flags[rr.astype(np.int64) * nc + cc.astype(np.int64)] = True
    return np.flatnonzero(flags), nr, nc


def build_tile_stack(coo, B, r1=None, r2=None, window1=None, window2=None):
    """Scatter a scipy COO region matrix into a TileStack.

    If (r1, r2, window sizes) are given, only tiles touched by those windows
    are materialized; otherwise all nonzero tiles are.
    One O(nnz) pass: tile-id per pixel, filter to touched, bincount-scatter.
    """
    n1, n2 = coo.shape
    nr, nc = -(-n1 // B), -(-n2 // B)

    # keep scipy's native dtypes (int32 indices / float32 data): the native
    # scatter has dtype-matched entry points, so forcing int64/float64 here
    # would only add ~200 MB of conversion copies at 12M nnz
    rows = np.asarray(coo.row)
    cols = np.asarray(coo.col)
    vals = np.asarray(coo.data)

    if r1 is not None:
        want, nr, nc = touched_tiles(r1, r2, window1, window2, B, (n1, n2))
    else:
        want = np.unique(
            (rows.astype(np.int64) // B) * nc + cols.astype(np.int64) // B
        )

    K = len(want)
    # +1 for the shared zero tile at stack index 0
    tile_map = np.zeros((nr + 1, nc + 1), dtype=np.int32)
    tr, tc = want // nc, want % nc
    tile_map[tr, tc] = np.arange(1, K + 1, dtype=np.int32)

    if K == 0 or len(rows) == 0:
        tiles = np.zeros((K + 1, B, B), dtype=np.float32)
        return TileStack(tiles=tiles, tile_map=tile_map, B=B, shape=(n1, n2))

    if _native_tile_scatter is not None:
        tiles = _native_tile_scatter(rows, cols, vals, tile_map, B, K, nc)
    else:
        pix_tile = tile_map[rows // B, cols // B].astype(np.int64)
        keep = pix_tile > 0
        rows, cols, vals, pix_tile = (
            rows[keep],
            cols[keep],
            vals[keep],
            pix_tile[keep],
        )
        flat_idx = pix_tile * (B * B) + (rows % B) * B + (cols % B)
        flat = np.bincount(flat_idx, weights=vals, minlength=(K + 1) * B * B)
        tiles = flat.reshape(K + 1, B, B).astype(np.float32)
    return TileStack(tiles=tiles, tile_map=tile_map, B=B, shape=(n1, n2))


def build_tile_stack_slab_sym(
    slab, B, r1=None, r2=None, window1=None, window2=None,
):
    """Upper-triangle build from a stored-triangle PixelSlab (cis): scatter
    runs with mirror=False onto the upper tile map (half the writes of the
    mirrored scatter), so diagonal tiles hold only the stored upper half
    (``diag_full=False`` — the device expansion symmetrizes them)."""
    n1, n2 = slab.shape
    assert n1 == n2 and slab.mirror, (
        "sym slab build requires a square cis region with a stored triangle"
    )
    nr, nc = -(-n1 // B), -(-n2 // B)
    if r1 is not None:
        want, nr, nc = touched_tiles(r1, r2, window1, window2, B, (n1, n2))
    else:
        lr = slab.rows - slab.lo1
        lc = slab.cols - slab.lo2
        t = np.unique((lr // B) * nc + lc // B)
        t = np.union1d(t, (lc // B) * nc + lr // B)
        want = t
    tile_map, utile_map, src, flip, diag, Ku = _sym_maps(want, nr, nc)

    if Ku == 0 or slab.nnz == 0:
        upper = np.zeros((Ku + 1, B, B), dtype=np.float32)
        return SymTileStack(
            upper=upper, tile_map=tile_map, src=src, flip=flip, diag=diag,
            diag_full=False, B=B, shape=(n1, n2),
        )
    if _native_tile_scatter_wtri is not None:
        upper = _native_tile_scatter_wtri(
            slab.rows, slab.cols, slab.vals, slab.lo1, slab.lo2, n1, n2,
            slab.weights, utile_map, B, Ku, False,
        )
    else:
        rows = slab.rows - slab.lo1
        cols = slab.cols - slab.lo2
        vals = slab.vals.astype(np.float64)
        if slab.weights is not None:
            vals = vals * slab.weights[slab.rows] * slab.weights[slab.cols]
        inb = (rows >= 0) & (rows < n1) & (cols >= 0) & (cols < n2)
        rows, cols, vals = rows[inb], cols[inb], vals[inb]
        pix_tile = utile_map[rows // B, cols // B].astype(np.int64)
        keep = pix_tile > 0
        flat_idx = (
            pix_tile[keep] * (B * B)
            + (rows[keep] % B) * B
            + (cols[keep] % B)
        )
        flat = np.bincount(
            flat_idx, weights=vals[keep], minlength=(Ku + 1) * B * B
        )
        upper = flat.reshape(Ku + 1, B, B).astype(np.float32)
    return SymTileStack(
        upper=upper, tile_map=tile_map, src=src, flip=flip, diag=diag,
        diag_full=False, B=B, shape=(n1, n2),
    )


def build_tile_stack_slab(
    slab, B, r1=None, r2=None, window1=None, window2=None,
):
    """Scatter a stored-triangle PixelSlab (io/cool.py::fetch_slab) into a
    TileStack in ONE fused pass: balancing weights and the symmetric mirror
    are folded into the native scatter, so the mirrored/balanced COO the
    reference materializes (coolpup.py:1053–1057) never exists on the host.
    Falls back to fetch_coo-equivalent numpy when the native lib is absent.

    Tiles to materialize come from the window list (r1/r2/window sizes),
    or are every tile the slab's pixels touch."""
    n1, n2 = slab.shape
    nr, nc = -(-n1 // B), -(-n2 // B)

    if r1 is not None:
        want, nr, nc = touched_tiles(r1, r2, window1, window2, B, (n1, n2))
    else:
        lr = slab.rows - slab.lo1
        lc = slab.cols - slab.lo2
        t = np.unique((lr // B) * nc + lc // B)
        if slab.mirror:
            t = np.union1d(t, (lc // B) * nc + lr // B)
        want = t

    K = len(want)
    tile_map = np.zeros((nr + 1, nc + 1), dtype=np.int32)
    tile_map[want // nc, want % nc] = np.arange(1, K + 1, dtype=np.int32)

    if K == 0 or slab.nnz == 0:
        tiles = np.zeros((K + 1, B, B), dtype=np.float32)
        return TileStack(tiles=tiles, tile_map=tile_map, B=B, shape=(n1, n2))

    if _native_tile_scatter_wtri is not None:
        tiles = _native_tile_scatter_wtri(
            slab.rows, slab.cols, slab.vals, slab.lo1, slab.lo2, n1, n2,
            slab.weights, tile_map, B, K, slab.mirror,
        )
        return TileStack(tiles=tiles, tile_map=tile_map, B=B, shape=(n1, n2))

    # numpy fallback: materialize weighted + mirrored local COO
    rows = slab.rows - slab.lo1
    cols = slab.cols - slab.lo2
    vals = slab.vals.astype(np.float64)
    if slab.weights is not None:
        vals = vals * slab.weights[slab.rows] * slab.weights[slab.cols]
    if slab.mirror:
        off = slab.rows != slab.cols
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, vals[off]]),
        )
    inb = (rows >= 0) & (rows < n1) & (cols >= 0) & (cols < n2)
    rows, cols, vals = rows[inb], cols[inb], vals[inb]
    pix_tile = tile_map[rows // B, cols // B].astype(np.int64)
    keep = pix_tile > 0
    rows, cols, vals, pix_tile = (
        rows[keep], cols[keep], vals[keep], pix_tile[keep],
    )
    flat_idx = pix_tile * (B * B) + (rows % B) * B + (cols % B)
    flat = np.bincount(flat_idx, weights=vals, minlength=(K + 1) * B * B)
    tiles = flat.reshape(K + 1, B, B).astype(np.float32)
    return TileStack(tiles=tiles, tile_map=tile_map, B=B, shape=(n1, n2))


def restack_indices(ts, Bb, r1, r2, window1, window2):
    """Host side of the on-device bucket restack: map a ``Bb``-sized tile
    grid (Bb a multiple of ts.B) onto the existing ts.B tile stack.

    Returns ``(tile_map_b, idx)``: ``tile_map_b`` is the [nr+1, nc+1]
    Bb-grid -> bucket-stack-index map, and ``idx`` [Kb+1, m, m] (m=Bb//B)
    holds source indices into ts.tiles so that bucket tile k is the m×m
    mosaic ts.tiles[idx[k]] (0 = shared zero tile). The device then builds
    the bucket stack with one take+transpose+reshape instead of the host
    re-scattering the region's pixels per extent bucket (the rescale path's
    dominant cost through a slow host↔device link)."""
    B = ts.B
    m = Bb // B
    assert m * B == Bb
    pairs, nr, nc = touched_tiles(r1, r2, window1, window2, Bb, ts.shape)
    Kb = len(pairs)
    tile_map_b = np.zeros((nr + 1, nc + 1), dtype=np.int32)
    tr, tc = pairs // nc, pairs % nc
    tile_map_b[tr, tc] = np.arange(1, Kb + 1, dtype=np.int32)
    g = ts.tile_map
    rr = np.broadcast_to(
        (tr[:, None, None] * m) + np.arange(m)[None, :, None], (Kb, m, m)
    )
    cc = np.broadcast_to(
        (tc[:, None, None] * m) + np.arange(m)[None, None, :], (Kb, m, m)
    )
    idx = np.zeros((Kb + 1, m, m), np.int32)
    ok = (rr < g.shape[0]) & (cc < g.shape[1])
    vals = np.zeros((Kb, m, m), np.int32)
    vals[ok] = g[rr[ok], cc[ok]]
    idx[1:] = vals
    return tile_map_b, idx


@lru_cache(maxsize=32)
def make_restack(m, B):
    """Jitted on-device restack: [K128, B, B] tiles + [Kb+1, m, m] indices
    -> [Kb+1, m·B, m·B] bucket tiles (see restack_indices). Cached per
    (m, B) like the step factories — a fresh closure per call would
    re-trace/re-lower the take for every extent bucket of every region."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def f(tiles, idx):
        sub = tiles[idx]  # [Kb+1, m, m, B, B]
        return jnp.transpose(sub, (0, 1, 3, 2, 4)).reshape(
            idx.shape[0], m * B, m * B
        )

    return f


_HOST_POOL = {}


def host_pool_buf(name, shape, dtype=np.float32):
    """Process-lifetime reusable host buffer (prefaulted). Large numpy
    temporaries go through mmap/munmap on this VM, where a page fault
    costs ~50 us — a fresh 245 MB window stack burned ~3 s in faults
    alone, every chunk. Callers own the buffer until their next call
    with the same name."""
    key = (name, np.dtype(dtype))
    need = int(np.prod(shape))
    b = _HOST_POOL.get(key)
    if b is None or b.size < need:
        b = np.empty(max(need, 1), dtype)
        b.fill(0)  # touch every page now, once
        _HOST_POOL[key] = b
    return b[:need].reshape(shape)


def assemble_windows_batch(stiles, tile_map, B, r1, r2, W, pool=None):
    """Vectorized host twin of assemble_window for fixed-size windows:
    group snips by tile quad, build each 2B×2B superwindow once, and cut
    all of its windows with direct slice copies (a sliding_window_view
    fancy gather and an elementwise [m, W, W] index gather were both
    slower; a per-snip np.block allocated ~0.5 MB per snip).

    ``stiles`` is the single NaN-encoded normalized stack
    (normalize_tile_stack), so the windows carry the reference NaN /
    poison semantics directly. Returns float32 ``data`` [N, W, W];
    accumulators fold it in float64 downstream. With ``pool``, reused
    prefaulted buffers are returned — valid only until the next pooled
    call with the same name (page faults cost ~50 us on this VM).
    """
    N = len(r1)
    r1 = np.asarray(r1, np.int64)
    r2 = np.asarray(r2, np.int64)
    if pool:
        out = host_pool_buf(pool + ".s", (N, W, W))
    else:
        out = np.empty((N, W, W), np.float32)
    t1, o1 = r1 // B, r1 % B
    t2, o2 = r2 // B, r2 % B
    ncol = tile_map.shape[1]
    quad = t1 * ncol + t2
    order = np.argsort(quad, kind="stable")
    qs = quad[order]
    starts = np.concatenate(
        [[0], np.flatnonzero(np.diff(qs)) + 1, [N]]
    ) if N else np.array([0, 0])
    for b in range(len(starts) - 1):
        lo, hi = starts[b], starts[b + 1]
        if hi <= lo:
            continue
        ids = order[lo:hi]
        tt1, tt2 = int(t1[ids[0]]), int(t2[ids[0]])
        sup = np.block(
            [
                [stiles[tile_map[tt1, tt2]], stiles[tile_map[tt1, tt2 + 1]]],
                [
                    stiles[tile_map[tt1 + 1, tt2]],
                    stiles[tile_map[tt1 + 1, tt2 + 1]],
                ],
            ]
        )
        for i, a, b in zip(
            ids.tolist(), o1[ids].tolist(), o2[ids].tolist()
        ):
            out[i] = sup[a : a + W, b : b + W]
    return out


def assemble_window(tiles, tile_map, B, r1, r2, h, w):
    """Cut one [h, w] dense window starting at (r1, r2) out of a tile stack —
    the host-side (numpy) twin of the device gather, used by the per-snip
    extension path (PileUpper.stream_snips). Windows span at most 2×2 tiles
    because B >= max window size."""
    t1, o1 = r1 // B, r1 % B
    t2, o2 = r2 // B, r2 % B
    sup = np.block(
        [
            [tiles[tile_map[t1, t2]], tiles[tile_map[t1, t2 + 1]]],
            [tiles[tile_map[t1 + 1, t2]], tiles[tile_map[t1 + 1, t2 + 1]]],
        ]
    )
    return sup[o1 : o1 + h, o2 : o2 + w]


def normalize_tile_stack(
    ts: TileStack,
    valid1,
    valid2,
    evec=None,
    ooe=False,
    cis=True,
    ignore_diags=2,
):
    """Pre-normalize a tile stack on the host into ONE NaN-encoded stack.

    For every materialized tile, applies the full per-pixel semantics of the
    reference hot loop (coolpup.py:1104–1156) — bad-bin masking, diagonal
    masking, OOE division — so the host snip stream (PileUpper.stream_snips,
    assemble_window[s_batch]) reduces to pure window cuts:

      stiles[k, x, y] = OOE-divided value where the pixel counts (+inf kept
                        at poison pixels, like the reference's sums),
                        NaN where masked out or NaN-valued.

    Consumers derive contribution = where(isnan(s), 0, s) and
    num = isfinite(s).

    The diagonal index of pixel (x, y) in tile (tr, tc) is
    tr*B + x - (tc*B + y).
    Returns ``stiles`` float32 [K+1, B, B]; slot 0 (the shared zero/empty
    tile) is all-NaN (contributes 0, counts 0).
    """
    B = ts.B
    tiles = ts.tiles
    K1 = tiles.shape[0]
    # recover (tr, tc) per stack slot from the grid lookup
    tr = np.zeros(K1, np.int64)
    tc = np.zeros(K1, np.int64)
    grid_r, grid_c = np.nonzero(ts.tile_map)
    tr[ts.tile_map[grid_r, grid_c]] = grid_r
    tc[ts.tile_map[grid_r, grid_c]] = grid_c

    n1, n2 = ts.shape
    # callers may pass valid vectors padded beyond the tiled extent (the
    # engine pow2-pads them); bins past the tile grid are unreachable, clip
    v1 = np.zeros(((n1 + 2 * B - 1) // B) * B + B, np.float32)
    m1 = min(len(valid1), len(v1))
    v1[:m1] = np.asarray(valid1, np.float32)[:m1]
    v2 = np.zeros(((n2 + 2 * B - 1) // B) * B + B, np.float32)
    m2 = min(len(valid2), len(v2))
    v2[:m2] = np.asarray(valid2, np.float32)[:m2]

    ar = np.arange(B)
    rows = tr[:, None] * B + ar[None, :]  # [K1, B]
    cols = tc[:, None] * B + ar[None, :]
    mask = v1[rows][:, :, None] * v2[cols][:, None, :]  # [K1, B, B]
    if cis and ignore_diags > 0:
        diag = rows[:, :, None] - cols[:, None, :]
        mask = mask * (np.abs(diag) >= ignore_diags)

    if ooe:
        if np.ndim(evec) == 0 or len(np.atleast_1d(evec)) == 1:
            ew = np.full((K1, B, B), float(np.atleast_1d(evec)[0]), np.float32)
        else:
            diag = np.abs(rows[:, :, None] - cols[:, None, :])
            epad = np.full(
                max(int(diag.max()) + 1, len(evec)), np.nan, np.float32
            )
            epad[: len(evec)] = evec
            ew = epad[diag]
        with np.errstate(divide="ignore", invalid="ignore"):
            val = tiles / ew
    else:
        val = tiles

    stiles = np.where(mask > 0, val, np.nan).astype(np.float32)
    stiles[0] = np.nan
    return stiles
