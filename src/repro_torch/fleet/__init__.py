"""`repro_torch.fleet` — multi-process serving: router, workers, peered cache.

The port's counterpart of ``repro.fleet``. The fleet stacks three pieces on
the single-process service:

  * :mod:`repro_torch.fleet.hashring` — consistent hashing over *stable
    worker slot names* ("w0", "w1", ...) keyed by the process-stable
    serialized cache key, so identical masks land on the same worker (and
    coalesce fleet-wide) and placement survives worker restarts;
  * :mod:`repro_torch.fleet.peering` — ``PeeredResultCache``: on a local
    miss a worker probes its siblings' caches over RPC before paying
    compute;
  * :mod:`repro_torch.fleet.router` — ``FleetRouter``: one HTTP front end
    fanning requests over N worker processes through the length-prefixed
    RPC, with DRR admission (the same ``Scheduler`` machinery the service
    uses), health checks, restart-on-death, and a rolled-up /metrics page.

``launch/serve.py --fleet N`` wires them together; each worker runs its
engine on the card unless started with ``--device cpu``.
"""

from repro_torch.fleet.hashring import HashRing
from repro_torch.fleet.peering import PeeredResultCache
from repro_torch.fleet.router import (
    FleetRouter,
    FleetSupervisor,
    RouterConfig,
    RouterThread,
    WorkerLink,
)

__all__ = [
    "FleetRouter",
    "FleetSupervisor",
    "HashRing",
    "PeeredResultCache",
    "RouterConfig",
    "RouterThread",
    "WorkerLink",
]
