"""Distribution layer: meshes of torch.distributed ranks, sharded batch
detection (port of partsbaseddetector_tpu/parallel).

The reference's only parallelism is shared-memory OpenMP loops
(reference: src/HOGFeatures.cpp:111-133, src/SpatialConvolutionEngine.cpp:
114-117, src/DynamicProgram.cpp:80-83).  Here mesh axes (data, filter)
or (scale, filter) map onto one process per device, with explicit
collectives and deterministic top-K candidate merges instead of the
reference's nondeterministic critical-section push_back
(src/DynamicProgram.cpp:246-251).  Importing it needs no process group.
"""

from partsbaseddetector_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh)
from partsbaseddetector_tpu_torch.parallel.sharded import (  # noqa: F401
    BatchDetector)
