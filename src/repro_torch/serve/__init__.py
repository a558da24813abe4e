"""serve of the PyTorch port (mirrors repro.serve)."""
