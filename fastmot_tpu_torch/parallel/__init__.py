"""Multi-stream serving (port of ``fastmot_tpu/parallel``): S streams
tracked with every stage batched over a leading stream axis, on one card
or sharded over the ('streams', 'model') mesh of ``torch.distributed``
(``make_stream_mesh``, ``shard_conv_channels``, ``mesh=``)."""
from .multi_mot import BatchedYOLODetector, MultiStreamMOT  # noqa: F401
from .stream_tracker import StreamTracker  # noqa: F401
from .streams import (conv_channel_plan, make_stream_mesh,  # noqa: F401
                      shard_conv_channels)
