"""Multi-stream parallel decode: the framework's primary scaling axis.

The reference is single-threaded per stream; the batched design instead
batches N concurrent streams into one XLA program over a [stream, ...] axis
(SURVEY.md §2.4), and shards that axis across a device mesh — embarrassingly
parallel, so XLA inserts no cross-chip collectives.
"""

from .batch import BatchedStreamDecoder
from .device_batch import DeviceFrontendDecoder
from .pool import PoolStepResult, StreamPool
from .sharding import (
    make_stream_mesh,
    shard_device_frontend_fn,
    shard_present_fn,
    shard_reconstruct_fn,
)

__all__ = ["BatchedStreamDecoder", "DeviceFrontendDecoder", "PoolStepResult",
           "StreamPool", "make_stream_mesh", "shard_device_frontend_fn",
           "shard_present_fn", "shard_reconstruct_fn"]
