"""Multi-device scaling: meshes of torch.distributed ranks, sharded batch
georeferencing, and the mosaic regrid with cross-rank reduction.

The two parallel axes of this domain:
  dp — frames sharded over ranks (data parallel; replaces the reference's
       NuMap process pipeline, spacecraft.py:334-361)
  sp — image rows sharded over ranks (spatial parallel; halo-free since the
       per-pixel chain is embarrassingly parallel — the only communication
       is the reduction of partial regrid bins)
"""

from auromat_tpu_torch.parallel.distributed import (  # noqa: F401
    global_mesh,
    initialize,
    is_multi_process,
)
from auromat_tpu_torch.parallel.mosaic import (  # noqa: F401
    mosaic_sequence,
    null_georef_params,
)
from auromat_tpu_torch.parallel.sharding import (  # noqa: F401
    gather_bands,
    make_grid_sharded_mosaic_step,
    make_mesh,
    make_sharded_mosaic_step,
    sharded_batch_georef,
)
