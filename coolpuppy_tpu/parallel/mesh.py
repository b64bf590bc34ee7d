"""Multi-chip SPMD pile-up over a jax.sharding.Mesh.

The reference scales with one process per region pair and a driver-side
reduce (reference coolpup.py:1502–1531). Here the same two decomposition axes
become mesh axes:

- ``regions``: a batch of region pairs, each with its own tile stack /
  valid-bin vectors / expected vector — sharded across this axis (the analog
  of the reference's Pool over chromosomes; across hosts this is the
  process axis).
- ``loci``: the snip stream of each region batch, sharded across this
  axis. Each device runs the fused gather/accumulate step on its local snip
  shard and the fixed-shape (sum, num, n, cov) accumulators are ``psum``-ed
  over BOTH axes — the collective counterpart of the reference's
  ``reduce(sum_pups, …)``, overlapped with compute by XLA.

Padding rows (snipmask=False) make shards shape-uniform, so sharding is purely
mechanical: results are bit-identical to the single-device step up to
f32 summation order.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.gather import GatherConfig, make_pileup_step_fn

def _shard_map(f, mesh, in_specs, out_specs):
    # check_vma=False: the scan carry is zero-initialized inside the
    # mapped function, which the varying-manual-axes checker rejects
    return jax.shard_map(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )


def make_mesh(devices=None, regions_axis=None):
    """Mesh with ("regions", "loci") axes over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if regions_axis is None:
        regions_axis = 2 if n % 2 == 0 and n > 1 else 1
    loci_axis = n // regions_axis
    arr = np.array(devices[: regions_axis * loci_axis]).reshape(
        regions_axis, loci_axis
    )
    return Mesh(arr, ("regions", "loci"))


def make_loci_mesh(devices=None):
    """1D mesh with a single "loci" axis over this process's devices — the
    production engine's snip-stream sharding axis (PileUpper(mesh=...)):
    every device holds the region's full tile stack (regions are small:
    block-sparse, bounded by touched windows) and gathers/accumulates its
    shard of the snip stream; accumulators are psum-ed.

    Defaults to jax.local_devices(), NOT jax.devices(): in a multi-process
    run each host pileups its own region pairs over its own chips and the
    per-region outputs merge across processes afterwards (parallel/distributed.py) —
    a global mesh would require all hosts to run the same region, which is
    the opposite decomposition."""
    devices = devices if devices is not None else jax.local_devices()
    return Mesh(np.asarray(devices), ("loci",))


@lru_cache(maxsize=64)
def make_engine_sharded_step(cfg: GatherConfig, mesh: Mesh):
    """shard_map of the fused pile-up step over the "loci" axis for the
    PRODUCTION engine (PileUpper._device_accumulate): per-region tile stack /
    valid / expected / coverage inputs are replicated, the snip index arrays
    [S_global = cfg.S * n_loci] are sharded, and the fixed-shape accumulators
    are psum-ed over the axis — the collective counterpart of the reference's
    driver-side ``reduce(sum_pups, …)`` (reference coolpup.py:1502–1531),
    overlapped with gather compute by XLA.

    Per-snip stripe planes (cfg.stripes) are returned sharded (each device
    computed its shard); out_spec P("loci") reassembles the global [S, W]
    arrays without replication."""
    return _shard_engine_step(make_pileup_step_fn(cfg), cfg, mesh, n_snip_args=5)


@lru_cache(maxsize=64)
def make_engine_sharded_rescale_step(cfg, mesh: Mesh):
    """Loci-sharded twin of the rescale step (extra h1/w2 snip arrays)."""
    from ..ops.rescale import make_rescale_step_fn

    return _shard_engine_step(make_rescale_step_fn(cfg), cfg, mesh, n_snip_args=7)


def _shard_engine_step(step, cfg, mesh, n_snip_args):
    """Common shard_map plumbing: 8 leading per-region args replicated,
    trailing ``n_snip_args`` snip arrays sharded over "loci", accumulators
    psum-ed, per-snip stripe planes left sharded."""
    acc_keys = (
        ["sum", "num", "poison"]
        + (["exp_sum", "exp_num"] if cfg.emit_expected else [])
        + (["cov_start", "cov_end"] if cfg.coverage else [])
    )

    def local_step(*args):
        out = step(*args)
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
        in_specs=(rep,) * 8 + (shard,) * n_snip_args,
        out_specs=out_specs,
    )
    return jax.jit(sharded)


def make_sharded_pileup_step(cfg: GatherConfig, mesh: Mesh):
    """shard_map the fused step over (regions, loci).

    Global input shapes (NR = region batch, sharded over "regions";
    S_global = cfg.S * mesh.shape["loci"], snips sharded over "loci"):

      tiles    [NR, K, B, B]     P("regions")
      tmap     [NR, M]           P("regions")
      evec     [NR, E]           P("regions")
      valid1/2 [NR, N]           P("regions")
      cov1/2   [NR, N]           P("regions")
      r1/r2/dd0/cid/snipmask [NR, S_global]  P("regions", "loci")

    Output accumulators are replicated (psum over both axes).
    """
    step = make_pileup_step_fn(cfg)

    def local_step(ncolp, tiles, tmap, evec, valid1, valid2, cov1, cov2,
                   r1, r2, dd0, cid, snipmask):
        # vmap the per-region step over the local region batch, then reduce
        outs = jax.vmap(
            lambda t, m, e, v1, v2, c1, c2, a, b, d, g, s: step(
                t, m, ncolp, e, v1, v2, c1, c2, a, b, d, g, s
            )
        )(tiles, tmap, evec, valid1, valid2, cov1, cov2,
          r1, r2, dd0, cid, snipmask)
        # sum over the local region batch, then all-reduce over the mesh
        outs = {k: v.sum(axis=0) for k, v in outs.items()}
        outs = {
            k: jax.lax.psum(jax.lax.psum(v, "loci"), "regions")
            for k, v in outs.items()
        }
        return outs

    region_spec = P("regions")
    snip_spec = P("regions", "loci")
    sharded = _shard_map(
        partial(local_step),
        mesh,
        in_specs=(
            P(),  # ncolp scalar, replicated
            region_spec,  # tiles
            region_spec,  # tmap
            region_spec,  # evec
            region_spec,
            region_spec,
            region_spec,
            region_spec,
            snip_spec,  # r1
            snip_spec,
            snip_spec,
            snip_spec,
            snip_spec,
        ),
        out_specs={
            k: P()
            for k in (
                ["sum", "num", "poison"]
                + (["exp_sum", "exp_num"] if cfg.emit_expected else [])
                + (["cov_start", "cov_end"] if cfg.coverage else [])
            )
        },
    )
    return jax.jit(sharded)


def sharded_pileup_demo_inputs(cfg: GatherConfig, mesh: Mesh, nr=None, seed=0):
    """Tiny synthetic global inputs for a sharded step (dry runs & tests)."""
    rng = np.random.default_rng(seed)
    nr = nr or mesh.shape["regions"]
    S_global = cfg.S * mesh.shape["loci"]
    K, B, W = 8, cfg.B, cfg.W
    n_bins = 4 * B
    nrow = -(-n_bins // B)
    tmap = np.zeros((nr, (nrow + 1) * (nrow + 1)), np.int32)
    for r in range(nr):
        grid = np.zeros((nrow + 1, nrow + 1), np.int32)
        grid[:nrow, :nrow] = rng.integers(0, K, (nrow, nrow))
        tmap[r] = grid.ravel()
    tiles = rng.gamma(1.0, 1.0, (nr, K + 1, B, B)).astype(np.float32)
    tiles[:, 0] = 0.0
    evec = np.linspace(1.0, 0.1, 2 * n_bins).astype(np.float32)[None].repeat(
        nr, 0
    )
    valid = (rng.random((nr, n_bins + B)) > 0.05).astype(np.float32)
    cov = rng.random((nr, n_bins + B)).astype(np.float32)
    r1 = rng.integers(0, n_bins - W, (nr, S_global)).astype(np.int32)
    r2 = rng.integers(0, n_bins - W, (nr, S_global)).astype(np.int32)
    dd0 = (r1 - r2).astype(np.int32)
    cid = rng.integers(0, cfg.capacity, (nr, S_global)).astype(np.int32)
    snipmask = np.ones((nr, S_global), bool)
    return (
        np.int32(nrow + 1),
        tiles,
        tmap,
        evec,
        valid,
        valid.copy(),
        cov,
        cov.copy(),
        r1,
        r2,
        dd0,
        cid,
        snipmask,
    )
