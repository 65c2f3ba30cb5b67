"""Multi-GPU domain decomposition (port of ``qex_tpu.parallel``): a
lattice split over the ranks of a ``torch.distributed`` process group,
with halo exchange and global sums (QEX's rank-grid decomposition,
SURVEY.md §2.11, §5.8)."""

from .mesh import (LatticeMesh, gather_field, local_block, make_lattice_mesh,
                   partition_geom)
from . import distributed

__all__ = ["LatticeMesh", "make_lattice_mesh", "partition_geom",
           "local_block", "gather_field", "distributed"]
