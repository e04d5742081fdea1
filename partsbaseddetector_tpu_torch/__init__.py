"""partsbaseddetector_tpu_torch — the PyTorch/CUDA port of the
mixtures-of-parts detector in ``partsbaseddetector_tpu``.

The JAX package stays the reference.  This package mirrors its layout
(``ops/hog.py`` <-> ``ops/hog.py`` and so on), imports ``torch``, numpy
and scipy only (PIL and PyYAML inside the functions that draw or parse
ORK configs), and runs on a CUDA device unless the caller passes
``device="cpu"``.  The backtracking walk, a Pallas kernel in the JAX
package, is a hand-written CUDA kernel here (``csrc/walk.cu``).
"""

__version__ = "0.1.0"

from partsbaseddetector_tpu_torch.models.schema import PartsModel  # noqa: F401
