"""DR-RL spectral machinery of the port."""
