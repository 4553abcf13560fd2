"""Configuration and device helpers of the PyTorch port."""
