"""Distributed pieces of the port: the liveness and straggler
bookkeeping the serving cluster's watchdog runs on
(``distributed.elastic``), and the sharded serving engine's layout
(``distributed.sharding``), its tensor-parallel weights
(``distributed.tensor_parallel``) and its attention across sites
(``distributed.pam_shard``)."""
