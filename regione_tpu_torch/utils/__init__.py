"""Port of regione_tpu.utils (the numpy-free helpers the port needs)."""
