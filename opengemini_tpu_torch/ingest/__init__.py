"""Ingest front-end: line protocol parsing and the columnar batch."""
