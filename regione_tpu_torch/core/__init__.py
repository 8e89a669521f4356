"""Port of regione_tpu.core."""
