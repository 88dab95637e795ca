"""``detector.device_ms`` in the cells where it moves ``device_ms_per_frame``."""
from motbench.measure import reader

read = reader("detector.device_ms")
