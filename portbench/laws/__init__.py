"""Laws of the traffic generator, one file each, found by name: a
mix's `"law": "<law>"` is `laws/<law>.py` (see `generate.py`)."""
