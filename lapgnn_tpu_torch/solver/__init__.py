"""Exact host solve and its certificate for the hybrid path."""
