"""Resilience planes of the port (only the fault points' hooks so far)."""
