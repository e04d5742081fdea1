"""ROS node adapter over StreamingDetector (port of
partsbaseddetector_tpu/frontends/ros_node.py).

Reference: ros/Node.cpp — init() loads the model, advertises the topic
set (Node.cpp:121-129), subscribes to ApproximateTime-synchronized
(depth image, rgb image, point cloud) streams (Node.hpp:104-108,143),
and depthImageCallback runs detect -> NMS -> 3-D post-processing,
publishing each message ONLY if that topic has subscribers
(Node.cpp:205-249).  Here the same gating happens through
StreamingDetector's lazily-materialized sinks: a sink is attached to a
topic exactly while the topic has subscribers, so unwanted messages are
never built.  Message payloads are constructed by frontends/messages.py
(the ros/Messages.cpp analog) — each publisher receives a typed message
object (ImageMsg / MarkerArray / PointCloudMsg / PoseArray), not a raw
array.

rospy is optional, so the transport is injected: any object
with ``advertise(topic, kind) -> publisher`` where a publisher has
``publish(msg)`` and ``get_num_connections()`` works (rospy.Publisher
satisfies the publisher half; a 10-line shim satisfies the rest).  When
rospy IS importable, :func:`make_rospy_transport` builds that object
with the correct per-kind message classes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from partsbaseddetector_tpu_torch.frontends import messages as msgs
from partsbaseddetector_tpu_torch.infer.stream import StreamingDetector
from partsbaseddetector_tpu_torch.post.depth import CameraModel

#: the detector-facade keys both frontends accept in their parameters
FACADE_PARAMS = ("k_per_level", "dp_split", "conv_engine", "walk_impl",
                 "compose", "device", "depth_prune", "mesh", "aot_dir")


def detector_kwargs(params: dict, own: Sequence[str]) -> dict:
    """StreamingDetector keyword arguments from a frontend's parameter
    dict.  own: the frontend's other keys.  An unknown key raises
    ValueError, as does ``aot_dir`` (the XLA executable cache, not
    carried by the port: ROADMAP.md queue 1 item 20).  ``mesh`` is a
    parallel.mesh.Mesh or its [data, filter] sizes, built with
    make_mesh on ``device`` (ValueError unless they match the world
    size)."""
    unknown = sorted(set(params) - set(own) - set(FACADE_PARAMS))
    if unknown:
        raise ValueError(f"unknown parameter(s) {unknown}; known: "
                         f"{sorted(set(own) | set(FACADE_PARAMS))}")
    if params.get("aot_dir") is not None:
        raise ValueError("aot_dir is not carried by the port: eager "
                         "torch has no executable to cache (ROADMAP.md "
                         "queue 1 item 20)")
    kw = {}
    for k in ("k_per_level", "dp_split"):
        if params.get(k) is not None:
            kw[k] = int(params[k])
    for k in ("conv_engine", "walk_impl", "compose", "device"):
        if params.get(k) is not None:
            kw[k] = str(params[k])
    if params.get("mesh") is not None:
        m = params["mesh"]
        if isinstance(m, (list, tuple)):
            from partsbaseddetector_tpu_torch.parallel.mesh import \
                make_mesh
            m = make_mesh(tuple(int(x) for x in m),
                          device=kw.get("device"))
        kw["mesh"] = m
    if params.get("depth_prune") is not None:
        from partsbaseddetector_tpu_torch.infer.detector import DepthPrune
        dp = params["depth_prune"]
        kw["depth_prune"] = (dp if isinstance(dp, DepthPrune)
                             else DepthPrune(**dp))
    return kw


def ros_available() -> bool:
    try:
        import rospy  # noqa: F401
        return True
    except ImportError:
        return False


# topic suffixes + message kinds, exactly the reference's advertise set
# (Node.cpp:121-129: image_transport for the two images, MarkerArray for
# bounding_box and part_centers, PointCloud for cleaned_cloud, PoseArray
# for object_poses)
TOPICS = {
    "overlay": ("candidates_rect_color", "image"),
    "mask": ("mask", "image"),
    "boxes3d": ("bounding_box", "marker_array"),
    "clusters": ("cleaned_cloud", "point_cloud"),
    "part_centers": ("part_centers", "marker_array"),
    "poses": ("object_poses", "pose_array"),
}


class PartsBasedDetectorNode:
    """The reference node's lifecycle over an injected transport.

    >>> node = PartsBasedDetectorNode(model, transport, camera=cam)
    >>> node.depth_image_callback(rgb, depth, cloud)   # per frame
    """

    def __init__(self, model, transport,
                 camera: Optional[CameraModel] = None,
                 ns: str = "/pbd/", name: Optional[str] = None,
                 remove_planes: bool = False, max_overlap: float = 0.1,
                 **detector_kwargs):
        """model: a PartsModel (routed to the right backend — multires
        models — by StreamingDetector) or a prebuilt detector backend.
        detector_kwargs: passed through to StreamingDetector
        (k_per_level, depth_prune, conv_engine, walk_impl, dp_split,
        compose, device) — the full facade surface, like the reference
        node's param set wraps its facade (ros/Node.cpp:72-105).
        name: the topic namespace and marker color; by default the
        model's name, which a prebuilt detector carries on its
        ``model``."""
        self.stream = StreamingDetector(
            model, camera=camera, max_overlap=max_overlap,
            remove_planes=remove_planes, **detector_kwargs)
        self.name = (name or getattr(model, "name", None)
                     or self.stream.model.name)
        prefix = ns + self.name + "/"
        self._pubs = {sink: transport.advertise(prefix + suffix, kind)
                      for sink, (suffix, kind) in TOPICS.items()}
        self._attached = {}
        # per-frame header copied from the input message, like the
        # reference stamping msg_out from msg_in (Messages.cpp:146-147)
        self._header = msgs.Header()
        # previous bounding-box markers, re-published as DELETE before
        # each new array (Messages.cpp:68-80)
        self._bb_markers = msgs.MarkerArray(markers=[])

    # ------------------------------------------------ message builders
    # sink payload -> typed message, one per topic (ros/Messages.cpp)
    def _publish_overlay(self, overlay):
        self._pubs["overlay"].publish(
            msgs.message_image_rgb(overlay, self._header))

    def _publish_mask(self, mask):
        self._pubs["mask"].publish(
            msgs.message_mask(mask, self._rgb, self._header))

    def _publish_boxes3d(self, boxes3d):
        pub = self._pubs["boxes3d"]
        if self._bb_markers.markers:
            pub.publish(msgs.clear_marker_array(self._bb_markers))
        self._bb_markers = msgs.message_bounding_box(
            boxes3d, self._header, self.name)
        pub.publish(self._bb_markers)

    def _publish_clusters(self, clusters):
        m = msgs.message_clusters(clusters, self._header)
        if m is not None:
            self._pubs["clusters"].publish(m)

    def _publish_part_centers(self, part_centers):
        self._pubs["part_centers"].publish(
            msgs.message_part_centers(part_centers, self._header,
                                      self.name))

    def _publish_poses(self, poses):
        # the poses sink carries post/poses.Pose objects (computed by
        # poses_from_part_centers — the same math message_poses wraps);
        # None entries are skipped like the reference's `continue`
        # (Messages.cpp:204-209).  post/poses quaternions are
        # (w, x, y, z); ROS field order is (x, y, z, w)
        arr = msgs.PoseArray(header=self._header, poses=[
            msgs.PoseMsg(position=tuple(p.position),
                         orientation=(p.orientation[1], p.orientation[2],
                                      p.orientation[3], p.orientation[0]))
            for p in poses if p is not None])
        self._pubs["poses"].publish(arr)

    def _sync_sinks(self) -> None:
        """Attach/detach sinks to mirror current subscriber counts —
        the analog of the reference's getNumSubscribers() guards
        (Node.cpp:205-249).  StreamingDetector only materializes a
        message when a sink is attached."""
        builders = {
            "overlay": self._publish_overlay,
            "mask": self._publish_mask,
            "boxes3d": self._publish_boxes3d,
            "clusters": self._publish_clusters,
            "part_centers": self._publish_part_centers,
            "poses": self._publish_poses,
        }
        for sink, pub in self._pubs.items():
            want = pub.get_num_connections() > 0
            if want and sink not in self._attached:
                fn = builders[sink]
                self.stream.on(sink, fn)
                self._attached[sink] = fn
            elif not want and sink in self._attached:
                self.stream._sinks[sink].remove(self._attached[sink])
                del self._attached[sink]

    def depth_image_callback(self, rgb, depth=None, cloud=None,
                             header: Optional[msgs.Header] = None):
        """One synchronized RGB-D frame (Node.cpp:160-249).  Inputs may
        be numpy arrays or messages (ImageMsg / PointCloudMsg); 16-bit
        depth is converted to meters with scale 1/1000 (the reference
        demo's convention, src/demo.cpp:95-99)."""
        rgb, depth, cloud, header = _unpack_frame(rgb, depth, cloud,
                                                  header)
        self._header = header
        self._rgb = rgb
        self._sync_sinks()
        return self.stream.process(rgb, depth, cloud)

    def depth_camera_callback(self, info) -> None:
        """Camera-info subscriber: initialize the camera model from the
        intrinsics message — the reference's depthCameraCallback
        (ros/Node.cpp:137-142; detectorCallback requires it before the
        3-D path runs).  ``info``: a (3, 3) K matrix, or any object
        with a ``.K`` attribute (sensor_msgs/CameraInfo exposes the
        row-major 3x3 as .K)."""
        K = np.asarray(getattr(info, "K", info), float).reshape(3, 3)
        self.stream.camera = CameraModel(fx=K[0, 0], fy=K[1, 1],
                                         cx=K[0, 2], cy=K[1, 2])

    @classmethod
    def from_params(cls, transport, params: dict,
                    camera: Optional[CameraModel] = None
                    ) -> "PartsBasedDetectorNode":
        """Construct from a ROS-private-param-style dict — the
        reference's init() flow (ros/Node.cpp:64-105: read ``model``,
        load by extension, read ``remove_planes``, distributeModel).
        Supported keys: model (path, required), remove_planes,
        max_overlap, ns, name — plus the detector-facade surface:
        k_per_level (int), conv_engine ("spatial"|"fft"), walk_impl
        ("auto"|"cuda"|"torch"), dp_split (int), compose, device (None
        = CUDA), depth_prune ({part_width_m, fx, tol} — depth-based
        response pruning) and mesh ([data, filter] axis sizes — serve on
        a mesh of torch.distributed ranks).  ``aot_dir`` and unknown
        keys raise ValueError (detector_kwargs)."""
        from partsbaseddetector_tpu_torch.models import load_any

        if "model" not in params:
            raise ValueError("param 'model' (model file path) required")
        kw = detector_kwargs(params, ("model", "remove_planes",
                                      "max_overlap", "ns", "name"))
        model = load_any(params["model"])
        return cls(model, transport, camera=camera,
                   ns=params.get("ns", "/pbd/"),
                   name=params.get("name"),
                   remove_planes=bool(params.get("remove_planes",
                                                 False)),
                   max_overlap=float(params.get("max_overlap", 0.1)),
                   **kw)

    def make_synchronizer(self, queue_size: int = 50,
                          slop: Optional[float] = None
                          ) -> msgs.ApproximateTimeSynchronizer:
        """3-stream ApproximateTime synchronizer feeding the callback,
        stream order (depth, rgb, cloud) exactly like the reference's
        KinectSyncPolicy subscribers (Node.hpp:104-108, Node.cpp:143:
        sync_(KinectSyncPolicy(50), image_sub_d_, image_sub_rgb_,
        pointcloud_sub_))."""
        def cb(depth_msg, rgb_msg, cloud_msg):
            header = None
            if isinstance(depth_msg, msgs.ImageMsg):
                header = depth_msg.header
            self.depth_image_callback(rgb_msg, depth_msg, cloud_msg,
                                      header=header)

        return msgs.ApproximateTimeSynchronizer(
            3, cb, queue_size=queue_size, slop=slop)


def _unpack_frame(rgb, depth, cloud, header):
    """Message-or-array inputs -> (rgb array, depth meters, cloud
    points, Header) — the cv_bridge unpack preamble
    (Node.cpp:163-179)."""
    if isinstance(rgb, msgs.ImageMsg):
        header = header or rgb.header
        rgb = rgb.to_array()
    if isinstance(depth, msgs.ImageMsg):
        header = header or depth.header
        depth = depth.to_array()
    if isinstance(cloud, msgs.PointCloudMsg):
        header = header or cloud.header
        cloud = cloud.points
    if depth is not None:
        depth = np.asarray(depth)
        if depth.dtype == np.uint16:    # mm -> meters (demo.cpp:95-99)
            depth = depth.astype(np.float32) / 1000.0
    return rgb, depth, cloud, (header or msgs.Header())


def make_rospy_transport():
    """Transport over real rospy (only call when ros_available()):
    advertises each topic with the matching ROS message class and
    converts the dataclass messages to rospy messages on publish."""
    import rospy
    from sensor_msgs.msg import Image, PointCloud2, PointField
    from geometry_msgs.msg import Pose, PoseArray, Point, Quaternion
    from visualization_msgs.msg import Marker, MarkerArray
    from std_msgs.msg import Header

    def _header(h: msgs.Header) -> Header:
        out = Header()
        out.stamp = rospy.Time.from_sec(h.stamp)
        out.frame_id = h.frame_id
        out.seq = h.seq
        return out

    def _image(m: msgs.ImageMsg) -> Image:
        out = Image()
        out.header = _header(m.header)
        out.height, out.width = m.height, m.width
        out.encoding = m.encoding
        out.is_bigendian = m.is_bigendian
        out.step = m.step
        out.data = m.data
        return out

    def _pose(p: msgs.PoseMsg) -> Pose:
        return Pose(position=Point(*p.position),
                    orientation=Quaternion(*p.orientation))

    def _marker(m: msgs.Marker) -> Marker:
        out = Marker()
        out.header = _header(m.header)
        out.ns, out.id = m.ns, m.id
        out.type, out.action = m.type, m.action
        out.pose = _pose(m.pose)
        out.scale.x, out.scale.y, out.scale.z = m.scale
        out.color.r, out.color.g, out.color.b, out.color.a = m.color
        out.lifetime = rospy.Duration(m.lifetime)
        return out

    def _marker_array(m: msgs.MarkerArray) -> MarkerArray:
        return MarkerArray(markers=[_marker(x) for x in m.markers])

    def _pose_array(m: msgs.PoseArray) -> PoseArray:
        return PoseArray(header=_header(m.header),
                         poses=[_pose(p) for p in m.poses])

    def _cloud(m: msgs.PointCloudMsg) -> PointCloud2:
        pts = np.asarray(m.points, np.float32)
        out = PointCloud2()
        out.header = _header(m.header)
        out.height, out.width = 1, len(pts)
        out.fields = [
            PointField(name=n, offset=4 * i,
                       datatype=PointField.FLOAT32, count=1)
            for i, n in enumerate("xyz")]
        out.is_bigendian = False
        out.point_step, out.row_step = 12, 12 * len(pts)
        out.data = pts.tobytes()
        out.is_dense = True
        return out

    KINDS = {
        "image": (Image, _image),
        "marker_array": (MarkerArray, _marker_array),
        "point_cloud": (PointCloud2, _cloud),
        "pose_array": (PoseArray, _pose_array),
    }

    class _Pub:
        def __init__(self, topic, kind):
            cls, self._convert = KINDS[kind]
            self._pub = rospy.Publisher(topic, cls, queue_size=1)

        def publish(self, msg):
            self._pub.publish(self._convert(msg))

        def get_num_connections(self):
            return self._pub.get_num_connections()

    class _Transport:
        def advertise(self, topic, kind):
            return _Pub(topic, kind)

    return _Transport()
