"""Drivers of the cells, one per kind of configuration (the `kind` of a configuration file names its module)."""
