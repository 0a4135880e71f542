"""Analysis plane of the port (only the lock factory so far)."""
