"""The streaming data tier (counterpart of ``mxnet_tpu/data/``):

* ``pipeline``: :class:`PrefetchQueue`, the bounded queue and shutdown
  protocol every prefetching producer shares;
* ``record_stream``: :class:`ShardedRecordStream` (every record once an
  epoch across ranks, a resumable cursor) and :class:`StreamingDataIter`
  (parallel decode, the cursor attached to every batch), with
  :class:`RawTensorDecoder` and :class:`ImageDecoder`;
* ``feed``: :class:`StagedKFeed`, the K-step device feed staged on a
  feeder thread and a stream of its own beside the window in flight.
"""
from .pipeline import PrefetchQueue  # noqa: F401
from .record_stream import (ImageDecoder, RawTensorDecoder,  # noqa: F401
                            ShardedRecordStream, StreamingDataIter)
from .feed import StagedKFeed, StagedWindow  # noqa: F401

__all__ = [
    "PrefetchQueue", "ShardedRecordStream", "StreamingDataIter",
    "RawTensorDecoder", "ImageDecoder", "StagedKFeed", "StagedWindow",
]
