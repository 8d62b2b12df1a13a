"""The PyTorch port's benchmark: see README.md."""
