"""Batched fixed-capacity post-processing."""
