"""Health-aware replica routing (the port's copy of
``dstack_tpu.routing``: the same picks, breaker transitions, affinity
keys and ``dtpu_router_*`` rendering), shared by the in-server proxy and
the standalone gateway: replica pools with a probed state machine
(STARTING → READY → DEGRADED → DRAINING → DEAD), least-outstanding
picking behind per-replica circuit breakers, failover forwarding, and
graceful draining. Exports ``dtpu_router_*`` metrics through the obs
package. Picks are KV-cache-aware: requests carry a prompt-prefix
digest chain and land on the replica already holding their prefix KV
unless that would breach the imbalance cap (routing/affinity.py,
serving.md §10)."""

from dstack_tpu_torch.routing.affinity import (
    AffinityConfig,
    AffinityKey,
    AffinityMap,
    request_affinity,
)
from dstack_tpu_torch.routing.forward import (
    copy_response_headers,
    filter_request_headers,
    forward_with_failover,
)
from dstack_tpu_torch.routing.metrics import get_router_registry, new_router_registry
from dstack_tpu_torch.routing.pool import (
    PoolConfig,
    PoolRegistry,
    ReplicaEntry,
    ReplicaPool,
    ReplicaState,
    get_pool_registry,
)

__all__ = [
    "AffinityConfig",
    "AffinityKey",
    "AffinityMap",
    "request_affinity",
    "PoolConfig",
    "PoolRegistry",
    "ReplicaEntry",
    "ReplicaPool",
    "ReplicaState",
    "copy_response_headers",
    "filter_request_headers",
    "forward_with_failover",
    "get_pool_registry",
    "get_router_registry",
    "new_router_registry",
]
