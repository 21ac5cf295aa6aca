"""Distributed pieces of the port: the liveness and straggler
bookkeeping the serving cluster's watchdog runs on and the elastic
re-mesh plan (``distributed.elastic``); the sharding rules of serving
and training (``distributed.sharding``), the tensor-parallel weights of
a sharded engine and of a train grid (``distributed.tensor_parallel``),
the attention across sites (``distributed.pam_shard``) and the GPipe
pipeline (``distributed.pipeline``)."""
