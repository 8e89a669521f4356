"""Port of regione_tpu.cli."""
