"""Distribution of the port: sharding specs and the ring model of
collective traffic (`repro.distributed`'s counterparts; its HLO analysis
has none, see `collectives.py`)."""
