"""Launchers: the profiling launcher (``python -m repro_torch profile``)."""
