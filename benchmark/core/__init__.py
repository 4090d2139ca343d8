"""What every cell of the benchmark shares (see ``benchmark/__init__.py``)."""
