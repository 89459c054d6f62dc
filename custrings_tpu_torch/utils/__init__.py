"""Host-side utilities of the port: CSV ingest and column statistics."""
