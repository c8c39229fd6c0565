"""Mesh axes and sharding rules (``sharding.py``), the port of
``repro/parallel``."""
