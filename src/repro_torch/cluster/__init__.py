"""Multi-device PAM cluster (paper §4.3) of the port: heterogeneous
device classes behind one router, inter-device KV migration, online load
balancing, and the fault-tolerance layer (chaos injection, watchdog,
replay, drain, checksummed transfer retry, preemption-by-demotion) over
N serving engines. Counterpart of ``repro.cluster``."""

from repro_torch.cluster.balancer import BalancerConfig, KVBalancer
from repro_torch.cluster.faults import FaultEvent, FaultInjector, parse_chaos
from repro_torch.cluster.migration import (KVSnapshot, SnapshotCorruption,
                                           can_migrate, migrate)
from repro_torch.cluster.recovery import RecoveryConfig, RecoveryManager
from repro_torch.cluster.router import (ClusterDevice, ClusterRouter,
                                        RouterConfig, build_cluster)
from repro_torch.cluster.spec import ClusterSpec, ReplicaGroup

__all__ = ["BalancerConfig", "ClusterDevice", "ClusterRouter", "ClusterSpec",
           "FaultEvent", "FaultInjector", "KVBalancer", "KVSnapshot",
           "RecoveryConfig", "RecoveryManager", "ReplicaGroup",
           "RouterConfig", "SnapshotCorruption", "build_cluster",
           "can_migrate", "migrate", "parse_chaos"]
