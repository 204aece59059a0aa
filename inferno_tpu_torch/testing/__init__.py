"""Synthetic fixtures for the port's tests and `chip_smoke.py`."""
