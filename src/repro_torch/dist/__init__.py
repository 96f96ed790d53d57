"""Copied from ``repro.dist``: so far the straggler detector the governor
feeds and the int8 gradient compression of the cross-pod reduction."""
