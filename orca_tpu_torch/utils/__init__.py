"""Port utilities."""
