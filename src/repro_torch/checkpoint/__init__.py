"""Atomic, async, keep-k checkpoints (``ckpt.py``)."""
