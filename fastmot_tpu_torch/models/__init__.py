"""Model zoo of the port: the darknet-cfg YOLOs, the SSD family and OSNet as
torch modules, plus the label map."""

from .label import get_label_name, set_label_map  # noqa: F401
from .registry import ReIDModel, SSDModel, YOLOModel  # noqa: F401
from . import osnet  # noqa: F401  (registers OSNet025 / OSNet10)
from . import ssd  # noqa: F401  (registers the three SSDs)
from . import yolo  # noqa: F401  (registers the eleven YOLOs)

SSD = SSDModel
YOLO = YOLOModel
ReID = ReIDModel
