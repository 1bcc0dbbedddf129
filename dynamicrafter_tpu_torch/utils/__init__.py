"""Weights, image and video IO."""
