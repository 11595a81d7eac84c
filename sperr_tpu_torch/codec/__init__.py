"""Host entropy coders of the port: copies of what it uses of sperr_tpu/codec."""
