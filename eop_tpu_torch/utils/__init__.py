"""Weight bridge and device selection."""
