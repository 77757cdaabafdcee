"""Online serving runtime: ``Server`` over a predict artifact (micro-
batching over a bucketed engine cache) or a generate artifact
(continuous batching over a paged KV cache), with admission control and
graceful drain."""
from .admission import (DeadlineExceeded, Evicted, Request,  # noqa: F401
                        ServeError, ServerBusy, ServerClosed)
from .decode import (GenerateConfig, GenerateRequest,  # noqa: F401
                     GenerateSession, PagedKVCache)
from .engine_cache import (BucketedEngineCache, check_buckets,  # noqa: F401
                           parse_buckets, pick_bucket)
from .metrics import DecodeMetrics, ServeMetrics, percentile  # noqa: F401
from .server import ServeConfig, Server  # noqa: F401
