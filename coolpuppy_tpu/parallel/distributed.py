"""Multi-host scaffolding: jax.distributed init, region-pair work
partitioning across processes, and cross-host reduction of region outputs.

The reference's only scale-out axis is a process pool over region pairs on
one node with a driver-side reduce (reference coolpup.py:1502–1531). Across
hosts the same axis becomes: each host ingests and piles up its subset
of region pairs (HDF5 reads stay host-local), then
the per-region outputs are allgathered across processes and reduced by the
same sum_pups monoid. Within each host, the "loci" mesh axis shards snip
streams over the local devices (parallel/mesh.py) with a psum.
"""

from __future__ import annotations


def init_distributed(**kwargs):
    """Initialize the jax distributed runtime for a multi-process run.

    With no arguments, jax reads the coordinator/process topology from the
    environment where the cluster provides one. No-op when already initialized or
    when running single-process. Returns (process_index, process_count)."""
    import jax

    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        # already initialized, or single-process without a coordinator
        pass
    return jax.process_index(), jax.process_count()


def local_region_pairs(pairs, process_index=None, process_count=None):
    """This process's share of the region-pair work list (round-robin, so
    large chromosomes spread across hosts)."""
    import jax

    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return [p for i, p in enumerate(pairs) if i % pc == pi]


def allreduce_region_maps(region_outputs):
    """Exchange per-region pileup outputs across processes so every host
    holds the full list (the cross-host counterpart of the reference's driver-side
    gather before ``reduce(sum_pups, …)``). Single-process: identity.

    Outputs are python dicts of numpy accumulators, so they travel as
    pickled bytes over the jax distributed client (size-prefixed, padded to
    a common length for the collective)."""
    import jax

    if jax.process_count() == 1:
        return region_outputs

    import pickle

    import numpy as np
    from jax.experimental import multihost_utils

    payload = np.frombuffer(
        pickle.dumps(region_outputs, protocol=pickle.HIGHEST_PROTOCOL),
        dtype=np.uint8,
    )
    sizes = multihost_utils.process_allgather(
        np.asarray([payload.size], np.int64)
    ).ravel()
    padded = np.zeros(int(sizes.max()), np.uint8)
    padded[: payload.size] = payload
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    merged = []
    for row, size in zip(gathered, sizes):
        merged.extend(pickle.loads(row[: int(size)].tobytes()))
    return merged
