"""Training data, NCHW (see ``vfidkr_torch/__init__.py``)."""
