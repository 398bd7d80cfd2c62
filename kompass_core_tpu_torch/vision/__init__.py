from .depth_detector import DepthDetector  # noqa: F401
from .kalman import LinearSSKalmanFilter  # noqa: F401
from .tracker import FeatureBasedBboxTracker  # noqa: F401
