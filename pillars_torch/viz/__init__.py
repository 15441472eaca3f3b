"""Visualization / ROS subsystem (reference L8).

The reference hard-wires rospy publishers through train.py, load_data.py and
scripts/ (SURVEY §2.3: send_3d_bbox, rviz_show_predictions, debug_save_points,
printConfidenceMap). Here every consumer talks to a :class:`Publisher`
interface; the ROS backend activates only when rospy imports, an offline
backend records to disk for headless runs, and matplotlib plotting
(viz/plot.py) is available for quick looks without RVIZ.
"""

from pillars_torch.viz.publisher import (  # noqa: F401
    BoxArray,
    NullPublisher,
    OfflinePublisher,
    make_publisher,
)
