"""``reid.device_ms`` in the cells where it moves ``device_ms_per_frame``."""
from motbench.measure import reader

read = reader("reid.device_ms")
