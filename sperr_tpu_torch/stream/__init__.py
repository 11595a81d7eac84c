"""Container format of the port: a copy of sperr_tpu/stream."""
