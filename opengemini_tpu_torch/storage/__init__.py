"""Storage: in-memory memtable shards and the engine."""
