"""One fleet worker process: ``python -m repro_torch.fleet.worker``.

The port's counterpart of ``repro.fleet.worker``. A worker is the
single-process stack — ``Engine`` (unmeshed; serialized cache keys need
process-stable components) behind ``Service`` behind ``FrontendServer`` —
plus a :class:`~repro_torch.fleet.peering.PeeredResultCache` so local
misses consult siblings before computing. The engine runs on the card
unless ``--device cpu`` is given; where no CUDA device is visible a worker
without it exits non-zero (it never falls back to the CPU). The
supervisor spawns workers with ephemeral ports (0) and parses the one-line
handshake this process prints once both listeners are bound::

    WORKER READY rpc=<port> http=<port>

SIGTERM (and SIGINT) drain the service before exit, so an orderly fleet
shutdown never abandons admitted requests.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading


READY_PREFIX = "WORKER READY"


def ready_line(rpc_port: int, http_port: int) -> str:
    return f"{READY_PREFIX} rpc={rpc_port} http={http_port}"


def parse_ready_line(line: str):
    """(rpc_port, http_port) out of a handshake line, or None."""
    line = line.strip()
    if not line.startswith(READY_PREFIX):
        return None
    try:
        kv = dict(part.split("=", 1)
                  for part in line[len(READY_PREFIX):].split())
        return int(kv["rpc"]), int(kv["http"])
    except (KeyError, ValueError):
        return None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.fleet.worker",
        description="one yCHG fleet worker (service + HTTP + RPC)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="HTTP port (0 = ephemeral)")
    ap.add_argument("--rpc-port", type=int, default=0,
                    help="framed TCP RPC port (0 = ephemeral)")
    ap.add_argument("--buckets", default="64,128",
                    help="comma-separated bucket sides")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=2.0)
    ap.add_argument("--cache-entries", type=int, default=1024)
    ap.add_argument("--max-queue-depth", type=int, default=None)
    ap.add_argument("--bucket-queue-depth", type=int, default=None)
    ap.add_argument("--policy", default="block", choices=["block", "shed"])
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="default: the CUDA device; 'cpu' is the only way "
                         "onto the CPU")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="build and load the CUDA kernel libraries in DIR "
                         "(a restarted worker loads them instead of "
                         "building them)")
    ap.add_argument("--trace-dump", default=None, metavar="PATH",
                    help="dump this worker's flight recorder as Chrome-trace "
                         "JSON to PATH.<pid> on shutdown")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.compile_cache:
        from repro_torch.launch.compilecache import enable_compile_cache

        enable_compile_cache(args.compile_cache)

    from repro_torch import obs
    from repro_torch.engine import Engine
    from repro_torch.fleet.peering import PeeredResultCache
    from repro_torch.frontend import ServerThread
    from repro_torch.service import Service, ServiceConfig

    if args.trace_dump:
        # per-process suffix: every worker of a supervisor shares the flag
        obs.configure(dump_path=f"{args.trace_dump}.{os.getpid()}")

    config = ServiceConfig(
        bucket_sides=tuple(int(b) for b in args.buckets.split(",")),
        max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
        cache_entries=args.cache_entries,
        max_queue_depth=args.max_queue_depth,
        bucket_queue_depth=args.bucket_queue_depth,
        overload_policy=args.policy,
    )
    engine = Engine(device=args.device)
    cache = PeeredResultCache(args.cache_entries, device=engine.device)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())

    with Service(engine, config, cache=cache) as svc:
        with ServerThread(svc, host=args.host, port=args.port,
                          rpc_port=args.rpc_port) as srv:
            print(ready_line(srv.rpc_port, srv.port), flush=True)
            stop.wait()
            obs.auto_dump("worker-shutdown")
            # context exits drain: ServerThread stops accepting, then
            # service.close() finishes every admitted request


if __name__ == "__main__":
    main()
