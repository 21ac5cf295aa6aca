"""Multi-device PAM cluster (paper §4.3) of the port: heterogeneous
device classes behind one router, inter-device KV migration and online
load balancing over N serving engines. Counterpart of ``repro.cluster``
without its fault-tolerance layer (ROADMAP Queue 1 item 8)."""

from repro_torch.cluster.balancer import BalancerConfig, KVBalancer
from repro_torch.cluster.migration import (KVSnapshot, SnapshotCorruption,
                                           can_migrate, migrate)
from repro_torch.cluster.router import (ClusterDevice, ClusterRouter,
                                        RouterConfig)
from repro_torch.cluster.spec import ClusterSpec, ReplicaGroup

__all__ = ["BalancerConfig", "ClusterDevice", "ClusterRouter", "ClusterSpec",
           "KVBalancer", "KVSnapshot", "ReplicaGroup", "RouterConfig",
           "SnapshotCorruption", "can_migrate", "migrate"]
