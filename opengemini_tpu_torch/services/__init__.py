"""Background services (ticked workers) of the PyTorch port."""
