"""Host-side frame I/O of the port (numpy only)."""
