"""wave_attempts_per_chunk: the mean, over the chunks or fields whose SPECK
bits the card wrote, of the tier index that held it (last_wave_tiers) plus
one.  The compressors try the tiers in order from the first, so that is the
number of device emissions the chunk took."""


def read(run):
    if not run.total("wave_chunks"):
        return None
    return run.total("attempts") / run.total("wave_chunks")
