"""Port of ``repro.collectives``."""
