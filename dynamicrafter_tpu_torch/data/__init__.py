"""Datasets and the host-side batch loader."""
