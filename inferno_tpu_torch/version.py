"""The package version: a copy of `inferno_tpu/version.py`."""

__version__ = "0.1.0"
