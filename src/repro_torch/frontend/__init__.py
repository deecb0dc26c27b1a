"""`repro_torch.frontend` — the network edge of the port's image service.

The counterpart of ``repro.frontend``, on the same wire.
`repro_torch.service` answers "how do I serve the algorithm to in-process
callers"; this package answers "how does traffic reach it over a wire":
an asyncio HTTP/JSON transport (plus an optional length-prefixed TCP RPC)
that bridges requests onto the threaded
:class:`~repro_torch.service.YCHGService`
with ``run_in_executor`` + futures, streams batched results as NDJSON in
completion order, maps admission-control sheds to HTTP 429 with a
drain-rate-derived ``Retry-After``, and exposes ``/healthz`` +
``/metrics`` (Prometheus text, per-bucket shed counters included).

    from repro_torch.engine import Engine
    from repro_torch.frontend import ServerThread, YCHGClient
    from repro_torch.service import ServiceConfig, YCHGService

    # Engine() runs on the card; Engine(device="cpu") on the CPU
    service = YCHGService(Engine(), ServiceConfig(bucket_sides=(128, 256)))
    with service, ServerThread(service) as srv, \\
            YCHGClient("127.0.0.1", srv.port) as client:
        out = client.analyze(mask)              # to_host()-shaped dict
        for item in client.analyze_batch(masks):  # completion order
            ...

Results over the wire are **bit-identical** to in-process
``service.submit`` (base64 of the raw array bytes, dtypes preserved) —
``tests/test_torch_frontend.py`` and ``launch.serve --frontend-smoke``
hold it to that bar.
"""

from repro_torch.frontend.client import (
    AsyncRPCClient,
    BatchItem,
    FrontendError,
    FrontendOverloaded,
    YCHGClient,
)
from repro_torch.frontend.server import FrontendServer, ServerThread

__all__ = [
    "AsyncRPCClient",
    "BatchItem",
    "FrontendError",
    "FrontendOverloaded",
    "FrontendServer",
    "ServerThread",
    "YCHGClient",
]
