"""Serving: dynamic batcher, detection service, HTTP front end."""
