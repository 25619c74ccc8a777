"""Ingest edge: the Influx line parser, the TCP gateway and test-data
producers (the counterpart of ``filodb_tpu.gateway``)."""
