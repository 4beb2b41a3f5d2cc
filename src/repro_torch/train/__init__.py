"""Training loops of the port."""
