"""Scenario-serving tier: continuous batching, admission control and
per-request SLO accounting over the port's chunked rollout programs.

Counterpart of the JAX package's ``serving/``: heterogeneous
:class:`~tpu_aerial_transport_torch.serving.queue.ScenarioRequest` traffic
is admitted through a bounded queue (``queue.py``), grouped by shape
bucket into batches that reuse one chunk program per family
(``batcher.py``; late arrivals join at the chunk seam, by a host splice or
lane selects on the card, ``lanes.py``), and driven by a host-side server
whose every dispatch goes through the backend guard (``server.py``).
Closed-loop MPC sessions ride on top (``sessions.py``); a content-
addressed result cache is optional (``cache.py``). Several replica
servers, each its own process on the card, serve one stream behind the
fleet front (``fleet.py``: consistent-hash routing, per-tenant admission,
lease supervision, failover re-dispatch). Preemption safety rides the
recovery journal and snapshots: a SIGTERM mid-batch completes at the
chunk boundary and a restarted process re-admits the remainder bitwise.
A server on a mesh over processes (``ScenarioServer(mesh=)``) runs each
process's slab of every batch and gathers the boundary carry whole. A
server given an AOT bundle (``ScenarioServer(bundle=, require_bundle=)``,
``aot/``) installs its kernel libraries from the bundle and runs no
``nvcc``.

Not ported yet: the JAX guard's CPU rung for work on the card (ROADMAP,
Queue 1): a chunk that fails on the card fails its requests with a
structured reason instead.
"""

from tpu_aerial_transport_torch.serving.fleet import (  # noqa: F401
    FleetFaultPlan,
    FleetFront,
    HashRing,
    ReplicaSupervisor,
    result_digest,
)
from tpu_aerial_transport_torch.serving.queue import (  # noqa: F401
    AdmissionQueue,
    ScenarioRequest,
    Ticket,
)
from tpu_aerial_transport_torch.serving.server import (  # noqa: F401
    ScenarioServer,
)
from tpu_aerial_transport_torch.serving.sessions import (  # noqa: F401
    SessionHost,
)
