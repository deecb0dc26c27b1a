"""The yCHG ROI service behind its HTTP front end, end to end.

The port's twin of ``examples/roi_service_http.py``. Starts the asyncio
front end on a loopback ephemeral port (ServerThread: the server runs on
its own event-loop thread, so this script stays plain blocking Python),
then drives it like a remote client would:

  1. one mask            -> POST /v1/analyze, result bit-identical to
                            in-process ``service.submit``;
  2. a streamed batch    -> POST /v1/analyze_batch, NDJSON lines arriving
                            in the server's completion order;
  3. overload            -> HTTP 429 + Retry-After once the per-bucket
                            admission allowance is full;
  4. observability       -> /healthz and /metrics (Prometheus text).

Run:  PYTHONPATH=src python -m repro_torch.examples.roi_service_http [--device cpu]
"""

import numpy as np

from repro_torch.engine import Engine
from repro_torch.examples import parse_device
from repro_torch.frontend import FrontendOverloaded, ServerThread, YCHGClient
from repro_torch.service import ServiceConfig, YCHGService


def seeded_masks() -> list:
    rng = np.random.default_rng(0)
    return [(rng.random((96, 128)) < 0.45).astype(np.uint8)
            for _ in range(6)]


def main(argv=None):
    device = parse_device(__doc__.splitlines()[0], argv)
    masks = seeded_masks()
    engine = Engine(device=device)

    config = ServiceConfig(bucket_sides=(128,), max_batch=4,
                           max_delay_ms=2.0, bucket_queue_depth=64)
    with YCHGService(engine, config) as service, \
            ServerThread(service) as server, \
            YCHGClient("127.0.0.1", server.port) as client:
        print(f"front end on http://127.0.0.1:{server.port}  "
              f"({client.health()['backend']} backend)")

        # 1. single mask over the wire == in-process submit, bit for bit
        wire = client.analyze(masks[0])
        local = service.submit(masks[0]).result(timeout=60).to_host()
        assert all(np.array_equal(wire[k], v) for k, v in local.items())
        print(f"single mask: {int(wire['n_hyperedges'])} hyperedges "
              f"(bit-identical to in-process)")

        # 2. streamed batch: results arrive in completion order
        print("streamed batch:")
        for item in client.analyze_batch(masks, ids=[f"roi-{i}" for i in
                                                     range(len(masks))]):
            print(f"  {item.id}: {int(item.result['n_hyperedges'])} "
                  f"hyperedges")

        # 4. observability
        for line in client.metrics_text().splitlines():
            if line.startswith(("ychg_submitted", "ychg_batches",
                                "ychg_cache_hits", "ychg_p95")):
                print(f"  /metrics  {line}")

    # 3. overload: one admission slot, held by a parked request -> the
    # wire answer is 429 with a drain-rate-derived Retry-After
    tight = ServiceConfig(bucket_sides=(128,), max_batch=4,
                          max_delay_ms=10_000.0, max_queue_depth=1,
                          overload_policy="shed")
    with YCHGService(engine, tight) as service:
        holder = service.submit(masks[0])
        with ServerThread(service) as server, \
                YCHGClient("127.0.0.1", server.port) as client:
            try:
                client.analyze(masks[1])
            except FrontendOverloaded as e:
                print(f"overload: HTTP 429, retry after "
                      f"{e.retry_after_s:.2f}s")
    holder.result(timeout=60)   # admitted work still completed on close


if __name__ == "__main__":
    main()
