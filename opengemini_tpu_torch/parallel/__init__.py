"""The cluster's data plane: placement, routed writes with hinted
handoff, the peers' aggregate pushdown and remote scans
(parallel/cluster.py), and the transport's fault rules
(parallel/netfault.py); the cluster operations' strict replication
(parallel/datarep.py); and the device mesh of one process, which splits
a batch's rows over shards and merges their partials
(parallel/runtime.py, parallel/distributed.py)."""
