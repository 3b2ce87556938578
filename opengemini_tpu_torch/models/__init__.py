"""Aggregate batches: grid, bucketed and scatter layouts on the device."""
