"""Host-side utilities of the port: CSV ingest, column statistics and
per-op tracing."""
