"""The benchmark of ``repro_torch``: ``bench/run.py`` runs one cell once."""
