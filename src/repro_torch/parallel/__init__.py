"""SPMD pipeline steps over ranks (``pipeline.py``), their collectives
(``comm.py``) and sharding rules (``sharding.py``)."""
