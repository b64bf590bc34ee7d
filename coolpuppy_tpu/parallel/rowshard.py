"""Row-partitioned tile storage across devices with a halo exchange.

The reference holds one whole-chromosome scipy CSR per worker process
(reference coolpup.py:1053–1077, README.md:30) — memory per worker scales
with the full region. The device counterpart named in SURVEY §2c/§5 is
row-partitioned sparse storage: each device's memory holds ONLY the block-sparse
tiles whose tile-row falls in its contiguous row band, snips are routed to
the device owning their start row, and the one boundary tile-row a window can
straddle (windows span at most 2 tile rows because B >= W) is exchanged
between neighboring devices with ``jax.lax.ppermute`` inside the
sharded step — the halo exchange. Accumulators psum over the "loci" axis,
exactly like the replicated-tiles path (parallel/mesh.py), but per-device
matrix memory drops from O(region) to O(region / n_devices + one tile row).

Host-side: :func:`build_row_partition` splits an existing TileStack by snip
load; :func:`route_snips` orders the snip stream device-major. Device-side:
:func:`make_row_sharded_step` wraps the fused pile-up step (ops/gather.py)
in shard_map with the ppermute halo. The engine routes every non-rescale
mesh region through this (engine/pileup.py, PileUpper._rowshard_accumulate);
over a multi-host "loci" axis the same program's halo ppermute and psum
cross hosts as well.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..ops.gather import GatherConfig, make_pileup_step_fn, _next_pow2

logger = logging.getLogger("coolpuppy_tpu")


@dataclass
class RowPartition:
    """Host-side description of a row-banded tile stack split.

    Arrays are padded so every device's slice has the same shape:

    - ``tiles``    [n, 1 + Kcap, B, B] — slot 0 is the shared zero tile,
      slots 1..K_d hold device d's own band tiles
    - ``tile_map`` [n, Mpad] raveled (nr+1, nc+1) grids; own tiles map to
      1..K_d, halo tiles (first row of the NEXT band) map to 1+Kcap+j
    - ``send_idx`` [n, Hcap] local stack indices of the tiles device d must
      ship to device d-1 (its own first tile-row), zero-padded
    - ``row_bounds`` tile-row band edges, length n+1
    """

    tiles: np.ndarray
    tile_map: np.ndarray
    send_idx: np.ndarray
    ncolp: np.int32
    row_bounds: np.ndarray
    n_dev: int
    B: int

    @property
    def per_device_tile_bytes(self):
        return self.tiles[0].nbytes + self.tile_map[0].nbytes


def _tile_rows_cols(tile_map):
    """Recover (tile_row, tile_col) per stack slot from the grid lookup."""
    K1 = int(tile_map.max()) + 1
    tr = np.zeros(K1, np.int64)
    tc = np.zeros(K1, np.int64)
    gr, gc = np.nonzero(tile_map)
    tr[tile_map[gr, gc]] = gr
    tc[tile_map[gr, gc]] = gc
    return tr, tc


def build_row_partition(tile_stack, r1, n_dev):
    """Split ``tile_stack`` into ``n_dev`` contiguous tile-row bands balanced
    by snip start-row load. Returns None when the region has fewer tile rows
    than devices (callers fall back to the replicated-tiles path)."""
    B = tile_stack.B
    nrp, ncp = tile_stack.tile_map.shape
    nr = nrp - 1  # last grid row/col are the all-zero boundary entries
    if nr < n_dev or tile_stack.tiles.shape[0] <= 1:
        return None

    # band edges at tile-row granularity, balancing the snip count per band
    # (cis snips are roughly uniform along the diagonal, but controls and
    # clustered features are not — use the actual distribution)
    t1 = np.asarray(r1, np.int64) // B
    hist = np.bincount(np.clip(t1, 0, nr - 1), minlength=nr).astype(np.float64)
    cum = np.cumsum(hist)
    targets = cum[-1] * np.arange(1, n_dev) / n_dev
    inner = np.searchsorted(cum, targets, side="left") + 1
    # STRICTLY increasing edges so every band owns >= 1 tile row — the halo
    # provider must be the direct +1 neighbor for the one-step ppermute.
    # Forward pass pushes each edge past its predecessor, backward pass pulls
    # edges below nr; nr >= n_dev guarantees a feasible assignment.
    for i in range(len(inner)):
        lo = inner[i - 1] + 1 if i else 1
        inner[i] = max(int(inner[i]), lo)
    for i in range(len(inner) - 1, -1, -1):
        hi = inner[i + 1] - 1 if i + 1 < len(inner) else nr - 1
        inner[i] = min(int(inner[i]), hi)
    row_bounds = np.concatenate([[0], inner, [nr]]).astype(np.int64)
    if not (np.diff(row_bounds) >= 1).all():
        # infeasible edge assignment (should be unreachable given nr >= n_dev,
        # but an assert would vanish under python -O and silently mis-route
        # halos) — let callers fall back to the replicated-tiles path
        return None

    tr, _tc = _tile_rows_cols(tile_stack.tile_map)
    K1 = tile_stack.tiles.shape[0]
    slots = np.arange(1, K1, dtype=np.int64)
    band_of_tile = np.searchsorted(row_bounds, tr[1:], side="right") - 1

    own = [np.sort(slots[band_of_tile == d]) for d in range(n_dev)]
    # halo for device d = the FULL first tile-row of band d+1 (windows end at
    # most one tile-row past the band; taking the whole row keeps the send
    # list independent of which columns d's snips touch)
    halo = [
        np.sort(slots[tr[1:] == row_bounds[d + 1]]) if d + 1 < n_dev else
        np.empty(0, np.int64)
        for d in range(n_dev)
    ]

    Kcap = _next_pow2(max(1, max(len(o) for o in own)))
    Hcap = _next_pow2(max(1, max(len(h) for h in halo)))
    # every device's buffer is padded to the LARGEST band's pow2 tile count,
    # so a skewed tile distribution erodes the per-device memory win — make
    # the achieved fraction visible (ADVICE r2: silent skew)
    frac = (1 + Kcap + Hcap) / max(1, K1)
    logger.debug(
        "rowshard: %d tiles -> %d bands, Kcap=%d Hcap=%d, "
        "per-device tile fraction %.2fx",
        K1 - 1, n_dev, Kcap, Hcap, frac,
    )

    tiles = np.zeros((n_dev, 1 + Kcap, B, B), np.float32)
    Mpad = _next_pow2(nrp * ncp)
    tile_map = np.zeros((n_dev, Mpad), np.int32)
    send_idx = np.zeros((n_dev, Hcap), np.int32)

    local_of = np.zeros((n_dev, K1), np.int32)  # global slot -> local index
    for d in range(n_dev):
        k = len(own[d])
        tiles[d, 1 : 1 + k] = tile_stack.tiles[own[d]]
        local_of[d, own[d]] = np.arange(1, 1 + k, dtype=np.int32)

    tr_grid, tc_grid = np.nonzero(tile_stack.tile_map)
    slot_grid = tile_stack.tile_map[tr_grid, tc_grid]
    for d in range(n_dev):
        grid = np.zeros((nrp, ncp), np.int32)
        mine = band_of_tile[slot_grid - 1] == d
        grid[tr_grid[mine], tc_grid[mine]] = local_of[d, slot_grid[mine]]
        # halo tiles live at 1+Kcap+j, j in the provider's send order
        # (both sides sort by global slot index, so orders agree)
        for j, g in enumerate(halo[d]):
            grid[tr_grid[slot_grid == g], tc_grid[slot_grid == g]] = (
                1 + Kcap + j
            )
        tile_map[d, : nrp * ncp] = grid.ravel()
        if d > 0:
            # what THIS device ships to d-1: its own first tile-row,
            # which is exactly halo[d-1] by construction
            send_idx[d, : len(halo[d - 1])] = local_of[d, halo[d - 1]]

    return RowPartition(
        tiles=tiles,
        tile_map=tile_map,
        send_idx=send_idx,
        ncolp=np.int32(ncp),
        row_bounds=row_bounds,
        n_dev=n_dev,
        B=B,
    )


def route_snips(part: RowPartition, r1):
    """Owner device per snip + a stable device-major order.

    Returns (order, counts): ``order`` permutes the snip stream so device 0's
    snips come first, etc.; ``counts[d]`` is device d's snip count. Original
    positions are recovered as ``order[routed_position]``."""
    t1 = np.asarray(r1, np.int64) // part.B
    owner = np.searchsorted(part.row_bounds, t1, side="right") - 1
    owner = np.clip(owner, 0, part.n_dev - 1)
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=part.n_dev)
    return order, counts


@lru_cache(maxsize=64)
def make_row_sharded_step(cfg: GatherConfig, mesh):
    """shard_map of the fused step over "loci" with ROW-SHARDED tiles.

    Per-device inputs (global leading axis n = mesh loci size, P("loci")):
    ``tiles`` [n, 1+Kcap, B, B], ``send_idx`` [n, Hcap], ``tmap`` [n, M],
    snip arrays [n, S]. The per-bin vectors (evec/valid/cov — O(region bins)
    floats, negligible next to the tile payload) stay replicated. Inside the
    mapped function each device gathers its boundary tile-row into a send
    buffer and ``ppermute``s it to its -1 neighbor — the halo exchange — then
    runs the ordinary fused step on [own tiles ‖ received halo]. Accumulators
    psum over the axis; per-snip stripe planes stay sharded."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from .mesh import _shard_map

    step = make_pileup_step_fn(cfg)
    n = int(mesh.shape["loci"])
    # device 0's first tile-row has no -1 neighbor to receive it (halo[n-1]
    # is empty by construction), so the wrap-around (0, n-1) pair would only
    # burn interconnect bandwidth; unaddressed ppermute receivers get zeros, which the
    # tile_map never references
    perm = [(i, i - 1) for i in range(1, n)]
    acc_keys = (
        ["sum", "num", "poison"]
        + (["exp_sum", "exp_num"] if cfg.emit_expected else [])
        + (["cov_start", "cov_end"] if cfg.coverage else [])
    )

    def local_step(tiles, send_idx, tmap, ncolp, evec, valid1, valid2,
                   cov1, cov2, r1, r2, dd0, cid, snipmask):
        tiles = tiles[0]  # [1+Kcap, B, B] — this device's row band only
        send_buf = tiles[send_idx[0]]  # [Hcap, B, B] first tile-row
        if n > 1:
            halo = jax.lax.ppermute(send_buf, "loci", perm)
        else:
            halo = send_buf
        full = jnp.concatenate([tiles, halo], axis=0)
        out = step(
            full, tmap[0], ncolp, evec, valid1, valid2, cov1, cov2,
            r1[0], r2[0], dd0[0], cid[0], snipmask[0],
        )
        for k in acc_keys:
            out[k] = jax.lax.psum(out[k], "loci")
        return out

    rep = P()
    shard = P("loci")
    out_specs = {k: rep for k in acc_keys}
    if cfg.stripes:
        out_specs["horizontal_stripe"] = shard
        out_specs["vertical_stripe"] = shard
    sharded = _shard_map(
        local_step,
        mesh,
        in_specs=(shard,) * 3 + (rep,) * 6 + (shard,) * 5,
        out_specs=out_specs,
    )
    return jax.jit(sharded)
