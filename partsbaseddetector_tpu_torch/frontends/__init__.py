"""Transport adapters: ROS node and ECTO/ORK cell shims (port of
partsbaseddetector_tpu/frontends/).

These map StreamingDetector's sinks onto the reference's two frontends
(reference: ros/Node.cpp:46-250, cells/detect.cpp:74-355).  The
transports themselves (rospy/rclpy, ecto) are optional, so both
adapters are import-guarded and transport-injected: they run against
any object with the small duck-typed surface they need (a publisher
factory / tendrils dicts), which is also how they are tested.
"""

from partsbaseddetector_tpu_torch.frontends import messages  # noqa: F401
from partsbaseddetector_tpu_torch.frontends.ros_node import (  # noqa: F401
    PartsBasedDetectorNode, ros_available)
from partsbaseddetector_tpu_torch.frontends.ecto_cell import (  # noqa: F401
    PartsBasedDetectorCell, ecto_available)
from partsbaseddetector_tpu_torch.frontends.ork_config import (  # noqa: F401
    OrkConfig, parse_by_parts)
