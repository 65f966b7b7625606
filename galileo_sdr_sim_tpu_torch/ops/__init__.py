"""Device engines of the PyTorch port."""
