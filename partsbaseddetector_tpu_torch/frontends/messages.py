"""ROS message construction — the analog of ros/Messages.cpp (the port's
own copy of ``partsbaseddetector_tpu/frontends/messages.py``).

The reference node builds concrete message payloads per topic
(reference: ros/Messages.cpp:55-235): overlay / mask images through
cv_bridge (:136-174), 3-D bounding-box CUBE markers with a
name-hashed color and the DELETE-then-ADD marker lifecycle (:68-130),
a concatenated cluster cloud (:176-185), and a PoseArray whose
orientation quaternion comes from the part-center covariance PCA
(:187-235).  rospy/ROS message classes are not importable in every
deployment, so this module defines structural dataclass equivalents
carrying exactly the reference's field set; `to_rospy` bridges hand
each to the real ROS classes when rospy is present (see
frontends/ros_node.make_rospy_transport).

It also provides :class:`ApproximateTimeSynchronizer`, the analog of
the node's 3-stream Kinect sync policy (reference: ros/Node.hpp:84-89,
104-108,143: message_filters ApproximateTime over depth image, rgb
image and point cloud with queue size 50).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from partsbaseddetector_tpu_torch.post.poses import \
    poses_from_part_centers
from partsbaseddetector_tpu_torch.post.rect3 import Rect3


# ---------------------------------------------------------------------
# message dataclasses (field sets mirror the ROS message definitions the
# reference fills in: std_msgs/Header, sensor_msgs/Image,
# visualization_msgs/Marker(Array), geometry_msgs/Pose(Array))
# ---------------------------------------------------------------------

@dataclasses.dataclass
class Header:
    stamp: float = 0.0          # seconds (ros::Time as a float)
    frame_id: str = ""
    seq: int = 0


@dataclasses.dataclass
class ImageMsg:
    """sensor_msgs/Image.  The reference fills this via
    cv_bridge::CvImage::toImageMsg (ros/Messages.cpp:141-148)."""

    header: Header
    height: int
    width: int
    encoding: str               # "rgb8" | "bgr8" | "mono8" | "32FC1"
    is_bigendian: int
    step: int                   # row stride in bytes
    data: bytes

    @staticmethod
    def from_array(arr: np.ndarray, encoding: str,
                   header: Optional[Header] = None) -> "ImageMsg":
        arr = np.ascontiguousarray(arr)
        h, w = arr.shape[:2]
        step = arr.strides[0]
        return ImageMsg(header=header or Header(), height=int(h),
                        width=int(w), encoding=encoding,
                        is_bigendian=0, step=int(step),
                        data=arr.tobytes())

    def to_array(self) -> np.ndarray:
        chan = {"rgb8": 3, "bgr8": 3, "mono8": 1}.get(self.encoding)
        if chan is None:
            if self.encoding == "32FC1":
                return np.frombuffer(self.data, np.float32).reshape(
                    self.height, self.width)
            raise ValueError(f"encoding {self.encoding!r}")
        a = np.frombuffer(self.data, np.uint8).reshape(
            self.height, self.width, chan)
        return a[..., 0] if chan == 1 else a


@dataclasses.dataclass
class PoseMsg:
    """geometry_msgs/Pose: position (x, y, z) + orientation quaternion
    (x, y, z, w) in ROS field order."""
    position: Tuple[float, float, float]
    orientation: Tuple[float, float, float, float]   # (x, y, z, w)

    IDENTITY_ORIENTATION = (0.0, 0.0, 0.0, 1.0)


@dataclasses.dataclass
class PoseArray:
    header: Header
    poses: List[PoseMsg]


@dataclasses.dataclass
class Marker:
    """visualization_msgs/Marker — the subset of fields the reference
    sets for its CUBE bounding boxes (ros/Messages.cpp:91-126)."""

    # type constants (visualization_msgs/Marker)
    ARROW, CUBE, SPHERE, CYLINDER = 0, 1, 2, 3
    # action constants
    ADD, MODIFY, DELETE = 0, 0, 2

    header: Header
    id: int
    type: int
    action: int
    pose: PoseMsg
    scale: Tuple[float, float, float]
    color: Tuple[float, float, float, float]    # r, g, b, a
    lifetime: float = 0.0                        # seconds; 0 = forever
    ns: str = ""


@dataclasses.dataclass
class MarkerArray:
    markers: List[Marker]


@dataclasses.dataclass
class PointCloudMsg:
    """The pcl::PointCloud<PointXYZRGB> analog the reference publishes
    for cleaned clusters (ros/Node.cpp:125, Messages.cpp:176-185):
    camera-frame points with optional per-point color."""
    header: Header
    points: np.ndarray                   # (N, 3) float32
    colors: Optional[np.ndarray] = None  # (N, 3) uint8 or None

    def __add__(self, other: "PointCloudMsg") -> "PointCloudMsg":
        cols = None
        if self.colors is not None and other.colors is not None:
            cols = np.concatenate([self.colors, other.colors])
        return PointCloudMsg(
            header=self.header,
            points=np.concatenate([self.points, other.points]),
            colors=cols)


# ---------------------------------------------------------------------
# message builders (ros/Messages.cpp:55-235, one function per message*)
# ---------------------------------------------------------------------

def hash_string_to_color(name: str) -> Tuple[float, float, float]:
    """Deterministic per-model color: hue = hash(name) % 360 degrees,
    s = 1, v = 0.7, converted HSV->RGB and scaled by 255
    (reference: ros/Messages.cpp:55-66 — including the quirk that the
    0..255-scaled values are later assigned to the 0..1 Marker color
    fields).  boost::hash is implementation-defined, so a stable CRC32
    stands in; the *distribution* property (stable distinct hues per
    name) is what the reference relies on."""
    hue = zlib.crc32(name.encode()) % 360
    s, v = 1.0, 0.7
    # standard HSV -> RGB (hue in degrees)
    c = v * s
    x = c * (1 - abs((hue / 60.0) % 2 - 1))
    m = v - c
    sector = int(hue // 60) % 6
    rgb = [(c, x, 0), (x, c, 0), (0, c, x),
           (0, x, c), (x, 0, c), (c, 0, x)][sector]
    return tuple((ch + m) * 255.0 for ch in rgb)


def message_image_rgb(overlay: np.ndarray, header: Header) -> ImageMsg:
    """Overlay image message (reference: ros/Messages.cpp:136-149).
    The pipeline is RGB-native end to end, so the encoding is rgb8
    (the reference's enc::RGB8)."""
    return ImageMsg.from_array(
        np.asarray(overlay, np.uint8), "rgb8", header)


def message_mask(mask: np.ndarray, rgb: np.ndarray,
                 header: Header) -> ImageMsg:
    """Instance-mask image message: the rgb image with everything
    outside detection masks zeroed — `rgb & (mask != 0)`
    (reference: ros/Messages.cpp:157-174; the reference emits BGR8
    because its pipeline is OpenCV-BGR; ours is RGB-native)."""
    rgb = np.asarray(rgb, np.uint8)
    out = np.where(np.asarray(mask)[..., None] != 0, rgb, 0)
    return ImageMsg.from_array(out, "rgb8", header)


def clear_marker_array(markers: MarkerArray) -> MarkerArray:
    """Flip every marker in the previous array to DELETE — the
    reference re-publishes the old array with action DELETE before
    building the new one, since there is no correspondence between
    time steps (reference: ros/Messages.cpp:68-74)."""
    return MarkerArray(markers=[
        dataclasses.replace(m, action=Marker.DELETE)
        for m in markers.markers])


def message_bounding_box(boxes3d: Sequence[Rect3], header: Header,
                         name: str, lifetime: float = 5.0
                         ) -> MarkerArray:
    """CUBE marker per 3-D bounding box (reference:
    ros/Messages.cpp:76-130): pose = box center with identity
    orientation, scale = box extents, color hashed from the model name
    with alpha 0.5, lifetime 5 s, id = index."""
    color = hash_string_to_color(name)
    markers = []
    for i, bb in enumerate(boxes3d):
        tl = np.asarray(bb.tl(), float)
        br = np.asarray(bb.br(), float)
        markers.append(Marker(
            header=header, id=i, type=Marker.CUBE, action=Marker.ADD,
            pose=PoseMsg(position=tuple((tl + br) / 2.0),
                         orientation=PoseMsg.IDENTITY_ORIENTATION),
            scale=tuple(br - tl),
            color=(color[0], color[1], color[2], 0.5),
            lifetime=lifetime))
    return MarkerArray(markers=markers)


def message_clusters(clusters: Sequence[np.ndarray],
                     header: Header) -> Optional[PointCloudMsg]:
    """Single concatenated cloud of all object clusters
    (reference: ros/Messages.cpp:176-185)."""
    if not len(clusters):
        return None
    pts = [np.asarray(c, np.float32).reshape(-1, 3) for c in clusters]
    return PointCloudMsg(header=header, points=np.concatenate(pts))


def message_part_centers(part_centers: Sequence[np.ndarray],
                         header: Header, name: str,
                         lifetime: float = 5.0) -> MarkerArray:
    """SPHERE marker per finite part center.  The reference advertises
    this MarkerArray topic (ros/Node.cpp:126-127) but its callback
    never constructs the message — completed here: one small sphere
    per part center, marker id encoding (object, part)."""
    color = hash_string_to_color(name)
    markers = []
    for obj, pc in enumerate(part_centers):
        pc = np.asarray(pc, float).reshape(-1, 3)
        for p, pt in enumerate(pc):
            if not np.isfinite(pt).all():
                continue
            markers.append(Marker(
                header=header, id=obj * 1000 + p, type=Marker.SPHERE,
                action=Marker.ADD,
                pose=PoseMsg(position=tuple(pt),
                             orientation=PoseMsg.IDENTITY_ORIENTATION),
                scale=(0.02, 0.02, 0.02),
                color=(color[0], color[1], color[2], 0.8),
                lifetime=lifetime))
    return MarkerArray(markers=markers)


def message_poses(header: Header,
                  part_centers: Sequence[np.ndarray]) -> PoseArray:
    """PoseArray from per-object part centers: position = centroid,
    orientation = quaternion of the covariance eigenvector frame
    (reference: ros/Messages.cpp:187-235).  Objects whose centroid
    cannot be computed are skipped, like the reference's `continue`
    (:204-209)."""
    poses = []
    for pose in poses_from_part_centers(part_centers):
        if pose is None:
            continue
        w, x, y, z = pose.orientation     # post/poses uses (w, x, y, z)
        poses.append(PoseMsg(position=tuple(pose.position),
                             orientation=(x, y, z, w)))
    return PoseArray(header=header, poses=poses)


# ---------------------------------------------------------------------
# ApproximateTime synchronizer (ros/Node.hpp:84-89,104-108,143)
# ---------------------------------------------------------------------

class ApproximateTimeSynchronizer:
    """N-stream approximate-time message synchronizer.

    The algorithm follows the message_filters ApproximateTime policy
    the reference instantiates for (depth image, rgb image, cloud)
    with queue size 50 (ros/Node.hpp:104-108, Node.cpp:143): maintain
    a queue per stream; whenever every queue is non-empty, take the
    latest head stamp as the pivot and, per stream, choose the queued
    message closest to the pivot — but only emit once every stream
    either holds a message at-or-after the pivot (so no later arrival
    could be closer) or is full.  Chosen and older messages are
    dropped; the callback receives one message per stream.

    >>> sync = ApproximateTimeSynchronizer(3, callback, queue_size=50)
    >>> sync.add(0, stamp, depth_msg); sync.add(1, stamp2, rgb_msg)...
    """

    def __init__(self, nstreams: int, callback: Callable,
                 queue_size: int = 50,
                 slop: Optional[float] = None):
        self.nstreams = int(nstreams)
        self.callback = callback
        self.queue_size = int(queue_size)
        self.slop = slop          # optional max span; None = unlimited
        self._queues: List[List[Tuple[float, object]]] = [
            [] for _ in range(self.nstreams)]

    def add(self, stream: int, stamp: float, msg) -> None:
        q = self._queues[stream]
        q.append((float(stamp), msg))
        q.sort(key=lambda sm: sm[0])
        if len(q) > self.queue_size:
            q.pop(0)
        self._try_emit(allow_partial_certainty=False)

    def flush(self) -> None:
        """Emit any well-formed set still in the queues (end-of-stream:
        no later arrivals are coming, so 'closest to pivot' is certain
        for every stream)."""
        self._try_emit(allow_partial_certainty=True)

    def _try_emit(self, allow_partial_certainty: bool) -> None:
        emitted = True
        while emitted and all(self._queues):
            emitted = False
            pivot = max(q[0][0] for q in self._queues)
            chosen = []
            for q in self._queues:
                certain = (q[-1][0] >= pivot
                           or len(q) >= self.queue_size
                           or allow_partial_certainty)
                if not certain:
                    return                      # wait for more data
                i = int(np.argmin([abs(s - pivot) for s, _ in q]))
                chosen.append(i)
            stamps = [self._queues[k][i][0]
                      for k, i in enumerate(chosen)]
            span = max(stamps) - min(stamps)
            if self.slop is not None and span > self.slop:
                # drop the oldest head and retry: this set can never
                # satisfy the slop, and heads only get older
                oldest = int(np.argmin([q[0][0] for q in self._queues]))
                self._queues[oldest].pop(0)
                emitted = True
                continue
            msgs = [self._queues[k][i][1]
                    for k, i in enumerate(chosen)]
            for k, i in enumerate(chosen):       # drop chosen + older
                del self._queues[k][:i + 1]
            self.callback(*msgs)
            emitted = True
