"""Copied from ``repro.dist``: so far only the straggler detector the
governor feeds."""
