"""device_idle_share (device): the share of the traced window in which no
kernel, copy or set ran on the card (torch.profiler's device activity)."""


def read(ctx):
    dev = ctx["device"]
    if dev is None:
        return None
    w0, w1 = ctx["window_us"]
    return 100.0 * (1.0 - dev.busy_s(w0, w1) / ((w1 - w0) / 1e6))
