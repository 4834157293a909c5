"""Serving models of the PyTorch port."""
