"""Host runtime of the port: the SPECK engines (a copy of sperr_tpu/runtime)."""
