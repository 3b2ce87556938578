"""The cluster's meta plane: the raft log (meta/raft.py), the replicated
state machine and its store (meta/service.py), and users with their
grants (meta/users.py)."""
