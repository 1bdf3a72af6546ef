"""Explicit SPMD over ``torch.distributed``: the pencil mesh.

Counterpart of ``spectral_tpu/parallel``.  Each process holds its slab of
a grid tensor as a plain tensor (no DTensor: K1's ctypes launch and the
Krylov core's host-side Givens both need plain tensors), and the
operators exchange data themselves: a derivative along a sharded axis
all_to_all-transposes the axis into the slab (``pencil.py``), a stencil
takes one edge plane from each neighbour (``halo.py``), and the Krylov
loop sums its inner products over the mesh (``Mesh.allreduce``, the
``reduce=`` hook of ``KSPConfig.solve``).
"""

from spectral_tpu_torch.parallel.mesh import (Mesh, gather_tensor, initialize_distributed,
                                              local_slices, make_mesh, shard_tensor)
from spectral_tpu_torch.parallel.pencil import (apply_axis_pencil, chebdiff_pencil,
                                                chebdiff_pencil2, chebdiff_pencil_pipelined,
                                                make_dif)
from spectral_tpu_torch.parallel.halo import halo_shift, stencil_apply_sharded

__all__ = ["Mesh", "make_mesh", "initialize_distributed", "local_slices", "shard_tensor",
           "gather_tensor", "apply_axis_pencil", "chebdiff_pencil", "chebdiff_pencil2",
           "chebdiff_pencil_pipelined", "make_dif", "halo_shift", "stencil_apply_sharded"]
