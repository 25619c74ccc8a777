"""Test-data producers (the counterpart of ``filodb_tpu.gateway``; the
Influx gateway server is not ported yet)."""
