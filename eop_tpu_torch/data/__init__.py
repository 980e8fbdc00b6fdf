"""Letterbox transforms and class names."""
