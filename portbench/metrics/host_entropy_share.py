"""host_entropy_share: the share of the window's chunks or fields whose
SPECK bits the host wrote (1 - last_wave_chunks over the chunks)."""


def read(run):
    if not run.total("enc_chunks"):
        return None
    return 1.0 - run.total("wave_chunks") / run.total("enc_chunks")
