"""Runnable examples of the port: ``baseline_configs``, BASELINE.json's
configurations 1-5 (the counterpart of ``examples/baseline_configs.py``)."""
