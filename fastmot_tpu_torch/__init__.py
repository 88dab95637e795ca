"""fastmot_tpu_torch: the PyTorch + CUDA port of ``fastmot_tpu``.

Same public surface as the JAX package (``MOT``, ``MultiTracker``,
``FeatureExtractor``, ``Flow``, ``Track``, ``KalmanFilter``; multi-stream
serving in ``parallel``), the same
module layout, and the same numeric choices; the device state lives in
torch tensors on the ``device`` given to ``MOT``. Imports torch, numpy
and scipy only: OpenCV is needed by ``VideoIO`` and drawing alone, and is
imported when one of them is used.
"""
from .mot import MOT  # noqa: F401
from .feature_extractor import FeatureExtractor  # noqa: F401
from .tracker import MultiTracker  # noqa: F401
from .kalman import KalmanConfig, KalmanFilter, MeasType  # noqa: F401
from .flow import Flow  # noqa: F401
from .track import Track  # noqa: F401

__version__ = '0.1.0'


def __getattr__(name):
    # VideoIO needs cv2; import it only when asked for
    if name == 'VideoIO':
        from .videoio import VideoIO
        return VideoIO
    raise AttributeError(name)
