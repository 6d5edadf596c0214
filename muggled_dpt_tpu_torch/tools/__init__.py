"""Measurement scripts for the port, run on a CUDA card (see each module's docstring)."""
