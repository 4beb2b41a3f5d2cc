"""Optimiser and learning-rate schedules of the port."""
