"""``osblock_roofline`` in the cells where it moves ``device_ms_per_frame``."""
from motbench.measure import reader

read = reader("osblock_roofline")
