"""Models behind the load generators: the single-device decoder transformer."""
