"""Object pose extraction from part centers (the port's own copy of
``partsbaseddetector_tpu/post/poses.py``).

Python counterpart of the reference ROS node's pose message builder
(reference: ros/Messages.cpp:187-235): per object, the position is the
centroid of its 3-D part centers, and the orientation quaternion comes
from the eigenvectors of the part-center covariance (PCA frame)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Pose:
    position: np.ndarray      # (3,)
    orientation: np.ndarray   # (4,) quaternion (w, x, y, z)


def _quat_from_matrix(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z) quaternion."""
    t = np.trace(R)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        return np.array([0.25 / s, (R[2, 1] - R[1, 2]) * s,
                         (R[0, 2] - R[2, 0]) * s,
                         (R[1, 0] - R[0, 1]) * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12))
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def poses_from_part_centers(parts_centers: Sequence[np.ndarray]
                            ) -> List[Optional[Pose]]:
    """Per object: centroid position + PCA-frame orientation
    (reference: ros/Messages.cpp:199-231).  Objects with no finite part
    centers yield None."""
    out: List[Optional[Pose]] = []
    for pc in parts_centers:
        pc = np.asarray(pc, float)
        if pc.size == 0:
            out.append(None)
            continue
        finite = np.isfinite(pc).all(axis=1)
        pts = pc[finite]
        if len(pts) == 0:
            out.append(None)
            continue
        centroid = pts.mean(axis=0)
        cov = np.cov(pts.T, bias=True) if len(pts) > 1 else np.eye(3)
        cov = np.atleast_2d(cov)
        if cov.shape != (3, 3):
            cov = np.eye(3)
        evals, evecs = np.linalg.eigh(cov)
        # right-handed frame
        if np.linalg.det(evecs) < 0:
            evecs[:, 0] = -evecs[:, 0]
        q = _quat_from_matrix(evecs)
        q = q / np.linalg.norm(q)
        out.append(Pose(position=centroid, orientation=q))
    return out
