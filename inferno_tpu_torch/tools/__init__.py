"""Command-line tools of the port: `profile_gpu` measures the profiling
blocks on the card, `build_profiles` turns raw sweeps into profile
documents. Counterparts of the repo's `tools/profile_tpu.py` and
`tools/build_profiles.py`."""
