"""Post-processing: depth-consistency pruning, 3-D boxes, point-cloud
clustering (the reference's L6 layer, without PCL/ROS dependencies).

numpy only: the port's own copies of ``partsbaseddetector_tpu/post/``.
"""
