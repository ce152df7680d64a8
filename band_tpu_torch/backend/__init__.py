"""Program builder and executor of the PyTorch port."""
