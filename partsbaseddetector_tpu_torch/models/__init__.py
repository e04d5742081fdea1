"""Model layer: schema, synthetic models, the packed device
representation and the transfer of packed weights from numpy."""

from partsbaseddetector_tpu_torch.models.schema import (  # noqa: F401
    ComponentSpec, PartSpec, PartsModel)
