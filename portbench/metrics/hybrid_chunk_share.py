"""hybrid_chunk_share: the share of the window's decoded chunks that the
card rebuilt from the host's control-only parse
(TorchDecompressor3D.last_hybrid_chunks over the chunks)."""


def read(run):
    if not run.total("dec_chunks"):
        return None
    return run.total("hybrid_chunks") / run.total("dec_chunks")
