"""Reference module alias: ``coolpuppy.coolpup`` -> the accelerator engine
(reference coolpup.py's public surface: CoordCreator, PileUpper, pileup,
and the free helpers)."""

from coolpuppy_tpu.coords import (  # noqa: F401
    CoordCreator,
    assign_groups,
    bin_distance_intervals,
    flip_mark_intervals,
)
from coolpuppy_tpu.engine.pileup import PileUpper, pileup  # noqa: F401
