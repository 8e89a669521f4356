"""Port of regione_tpu.pipelines."""
