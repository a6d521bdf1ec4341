"""Rendering across several devices (``mesh.py``)."""
