"""LiDAR perception engine on an accelerator, in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
C++/PCL/ROS2 pipeline (YevgeniyEngineer/LiDAR-Processing): ground segmentation
(GPF), Euclidean clustering (FEC-equivalent radius-graph connected components),
and concave/convex polygonization, with a device-resident streaming runtime and
mesh-sharded multi-chip execution.
"""

from .config import (ClusteringConfig, EngineConfig, PipelineConfig,
                     PolygonizationConfig, SegmentationConfig, DEFAULT_CONFIG)
from .types import (CLUSTER_INVALID, CLUSTER_UNDEFINED, SEG_GROUND,
                    SEG_OBSTACLE, SEG_UNKNOWN, PointCloud, pad_cloud)

__version__ = "0.1.0"
