"""Model family of the port (dense decoder-only)."""
