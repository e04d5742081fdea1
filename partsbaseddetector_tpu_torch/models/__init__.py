"""Model layer: schema, serialization (FileStorage XML/YAML, Matlab .mat,
native .npz), synthetic models, the packed device representation and
the transfer of packed weights from numpy."""

from partsbaseddetector_tpu_torch.models.schema import (  # noqa: F401
    ComponentSpec, PartSpec, PartsModel, flatten_filter, unflatten_filter)
from partsbaseddetector_tpu_torch.models.filestorage import (  # noqa: F401
    load_model as load_filestorage, save_model as save_filestorage)
from partsbaseddetector_tpu_torch.models.matio import (  # noqa: F401
    load_mat, save_mat)


def load_any(path: str) -> "PartsModel":
    """Load a model by extension, mirroring the demo's loader dispatch
    (reference: src/demo.cpp:63-77)."""
    if path.endswith((".xml", ".yml", ".yaml")):
        return load_filestorage(path)
    if path.endswith(".mat"):
        return load_mat(path)
    if path.endswith(".npz"):
        from partsbaseddetector_tpu_torch.models.npzio import load_npz
        return load_npz(path)
    raise ValueError(f"unsupported model extension: {path}")
