"""Host-side utilities of the port: the random stream, snapshot output and
the split of pose rows."""
