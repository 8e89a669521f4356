"""Port of regione_tpu.models."""
