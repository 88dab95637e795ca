"""Multi-stream serving (port of ``fastmot_tpu/parallel``): S streams
tracked on one card with every stage batched over a leading stream axis.
The mesh (``parallel/streams.py``, ``mesh=``) is not ported."""
from .multi_mot import BatchedYOLODetector, MultiStreamMOT  # noqa: F401
from .stream_tracker import StreamTracker  # noqa: F401
