"""Scorer-replica model loading."""
