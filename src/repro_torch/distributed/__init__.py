"""Distributed training substrate: on one device, the host-side fault
hooks of the training loop (``fault.py``)."""
