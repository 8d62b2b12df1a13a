"""Multi-device runs: the data mesh and its collectives (`mesh.py`)."""
