"""Error surface for the chunked codecs (reference: RTNType, sperr_helper.h:54-64).

The reference propagates per-chunk failures as the FIRST failing chunk's
RTNType code (SPERR3D_OMP_C.cpp:132-135, the omp loop's error reduction).
The Python codecs mirror that as exceptions:

  * ``StreamError``  — malformed/unsupported container or chunk stream
    (re-exported from stream.tools; the RTNType::WrongLength/BitstreamWrongLen
    family);
  * ``ChunkError``   — a chunk failed to (de)compress; carries the GLOBAL
    chunk index (container order) of the first failure plus the underlying
    cause.  When several chunks fail concurrently on the thread pool, the
    one with the smallest chunk index is raised, matching the reference's
    deterministic first-failure semantics.

The port's copy of sperr_tpu/errors.py; only its imports differ.
"""

from __future__ import annotations

from .stream.tools import StreamError

__all__ = ["StreamError", "ChunkError", "first_chunk_failure"]


class ChunkError(RuntimeError):
    """A per-chunk pipeline failure, identified by container chunk index."""

    def __init__(self, chunk_index: int, cause: BaseException):
        super().__init__(f"chunk {chunk_index}: {type(cause).__name__}: {cause}")
        self.chunk_index = int(chunk_index)
        self.__cause__ = cause


def first_chunk_failure(errors):
    """errors: iterable of (chunk_index, exception) — raise the failure with
    the smallest chunk index (reference first-failing-chunk reduction); no-op
    on an empty list."""
    errors = [e for e in errors if e is not None]
    if not errors:
        return
    idx, cause = min(errors, key=lambda t: t[0])
    raise ChunkError(idx, cause)
