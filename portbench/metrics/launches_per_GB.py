"""launches_per_GB.<op>: hand-kernel launches over the window (the change
of sum(sperr_tpu_torch.kernels.launches)) per GB of float32 data the
window's requests encoded or decoded."""


def read(run):
    gb = (run.bytes_in + run.bytes_out) / 1e9
    if not gb:
        return None
    return run.launches / gb
