"""Data of the port: synthetic streams and the byte-level text corpus."""
