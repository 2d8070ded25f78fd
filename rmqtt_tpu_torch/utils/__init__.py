"""Device utilities."""
