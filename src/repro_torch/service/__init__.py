"""`repro_torch.service` — the port's batching, caching image service.

The counterpart of ``repro.service``. ``repro_torch.engine.Engine`` answers
"how do I run operator X on this tensor"; this package answers "how do I
serve it": single-mask requests coalesce through a micro-batching
scheduler into ``(op, side, dtype)``-bucketed stacks padded to a
power-of-two sub-batch ladder, behind a content-addressed LRU result cache
(a hit never invokes a backend), over a double-buffered dispatch loop.
``max_queue_depth`` + ``overload_policy`` add admission control: past the
bound, ``submit`` blocks (backpressure) or raises
:class:`ServiceOverloaded` (shed). The scheduler, metrics and cache are
copies of the JAX package's. Every registered op is served
(``submit(mask, op="ccl")``), and ordered op chains run on the device end
to end (``submit_pipeline(mask, ["denoise", "ychg"])``).

    from repro_torch.service import ServiceConfig, YCHGService

    with YCHGService(config=ServiceConfig(bucket_sides=(256,))) as svc:
        fut = svc.submit(mask)          # Future[YCHGResult], non-blocking
        result = fut.result()           # ready, device-resident, B=1 view
        result2 = svc.analyze(mask)     # cache hit: same object back
        print(svc.metrics())            # queue depth, p50/p95, hit rate, ...

Results are bit-identical to ``engine.analyze(mask)`` for every request,
through padding, bucketing, arrival order, duplicates and caching
(``tests/test_torch_service.py``, ``tests/test_torch_ops.py``).
"""

from repro_torch.service.batching import (
    crop_for,
    crop_result,
    pad_stack,
    pick_bucket_side,
)
from repro_torch.service.cache import ResultCache, make_key
from repro_torch.service.metrics import MetricsRecorder, ServiceMetrics
from repro_torch.service.scheduler import (
    DeadlineExceeded,
    DrainRate,
    Scheduler,
    SchedulerConfig,
    ServiceOverloaded,
    TenantQuotaExceeded,
    TokenBucket,
    pick_sub_batch,
    sub_batch_ladder,
)
from repro_torch.service.service import Service, ServiceConfig, YCHGService

__all__ = [
    "DeadlineExceeded",
    "DrainRate",
    "MetricsRecorder",
    "ResultCache",
    "Scheduler",
    "SchedulerConfig",
    "TenantQuotaExceeded",
    "TokenBucket",
    "Service",
    "ServiceConfig",
    "ServiceMetrics",
    "ServiceOverloaded",
    "YCHGService",
    "crop_for",
    "crop_result",
    "make_key",
    "pad_stack",
    "pick_bucket_side",
    "pick_sub_batch",
    "sub_batch_ladder",
]
