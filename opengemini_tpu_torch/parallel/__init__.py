"""The cluster's data plane: placement, routed writes with hinted
handoff, the peers' aggregate pushdown and remote scans
(parallel/cluster.py), and the transport's fault rules
(parallel/netfault.py)."""
