"""Fault-tolerance runtime of the training loop (``fault.py``)."""
