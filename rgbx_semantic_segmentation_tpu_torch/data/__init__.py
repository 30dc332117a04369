"""Host-side data code of the port (numpy and PIL only)."""
