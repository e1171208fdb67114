"""Serving entry points of the LM substrate, ported from ``repro/launch``."""
