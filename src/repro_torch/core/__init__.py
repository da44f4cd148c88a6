"""Refactoring state: the Eq. 10 snapshot and merges (``refactoring``)."""
