"""coolpuppy-tpu: accelerator-native sparse pile-up (APA) engine for Hi-C
data.

Same capabilities as open2c/coolpuppy (reference), re-architected for
JAX/XLA on an NVIDIA GPU. See DESIGN.md for the architecture.
"""

def _tune_allocator():
    """Keep large numpy buffers on the reusable glibc heap.

    By default glibc mmap()s allocations over ~128 KB and munmap()s them
    on free, so every large temporary re-pays first-touch page faults, which
    are slow on virtualized hosts.
    Raising M_MMAP_THRESHOLD keeps those buffers on the heap where freed
    blocks are reused already-faulted; the 256 MB trim threshold still
    returns memory to the OS once more than that sits free at the heap
    top, so host applications that import this library are not pinned at
    their high-water mark. Set COOLPUPPY_TPU_NO_MALLOC_TUNE=1 to skip
    entirely (the engine then simply runs with default glibc behavior)."""
    import ctypes
    import os

    if os.environ.get("COOLPUPPY_TPU_NO_MALLOC_TUNE"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 256 << 20)  # M_TRIM_THRESHOLD
    except Exception:
        pass


_tune_allocator()

from ._version import __version__  # noqa: F401,E402
from .coords import CoordCreator, assign_groups, bin_distance_intervals  # noqa: F401
from .engine import PileUpper, pileup  # noqa: F401
from .io import Cooler, write_cool  # noqa: F401
