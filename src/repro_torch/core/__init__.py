"""Host-side runtime copied from ``repro.core``: phase events, policies,
the P-state model, the timeout tuners and the governor.  No torch here."""
