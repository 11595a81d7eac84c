"""Chunked drivers over the dense device stages."""
