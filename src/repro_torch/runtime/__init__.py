"""Fault-tolerance runtime of the training loop (``fault.py``) and the
elastic mesh (``elastic.py``)."""
