"""Ingest-side health state (the counterpart of ``filodb_tpu.ingest``; the
durable streams and ingestion drivers are not ported yet)."""
