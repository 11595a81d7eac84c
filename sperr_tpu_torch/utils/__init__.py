"""Host utilities of the port: copies of sperr_tpu/utils (dims, packing, test data)."""
