"""Distributed pieces of the port: so far the liveness and straggler
bookkeeping the serving cluster's watchdog runs on
(``distributed.elastic``)."""
