"""Core layer: schemas, record format, tag index and the in-memory
time-series store (copies of ``filodb_tpu.core``)."""
