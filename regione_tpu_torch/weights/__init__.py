"""Port of regione_tpu.weights."""
