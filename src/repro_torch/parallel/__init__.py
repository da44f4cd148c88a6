"""The GPipe train step at one rank (``pipeline.py``)."""
