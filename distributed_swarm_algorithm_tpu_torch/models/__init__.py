"""User-facing models of the PyTorch port."""
