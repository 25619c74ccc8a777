"""roofline.window_eval (kernels): the gauge window evaluators' share of
their roofline over the window: for the calls of tilestore.evaluate_aligned
(avg_over_time) and the packed gather (max_over_time), the least time that
their query shapes' bytes and operations need at the card's peaks
(roofline/window_eval.py), over the device time of the kernels each call
launched."""

from portbench.harness.peaks import card_rates


def read(ctx):
    calls = ctx["probes"].get("window_eval", [])
    dev, rates = ctx["device"], card_rates(ctx["card"])
    if not calls or dev is None or rates is None:
        return None
    rl = ctx["bench"].roofline("window_eval")
    w0, w1 = ctx["window_us"]
    times = dev.launched_in(calls, w0, w1)
    bw, flops = rates
    least = busy = 0.0
    for c, t in zip(calls, times):
        if t > 0:
            b, o = rl.call_bytes_ops(c, ctx["cfg"])
            least += max(b / bw, o / flops)
            busy += t
    return 100.0 * least / busy if busy > 0 else None
