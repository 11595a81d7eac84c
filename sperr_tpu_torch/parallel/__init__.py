"""Chunked drivers over the dense device stages, on one device, split over
several (``devices=``), or across processes (``distributed``)."""
