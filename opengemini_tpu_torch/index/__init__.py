"""Series indexing: the in-memory inverted tag index."""
