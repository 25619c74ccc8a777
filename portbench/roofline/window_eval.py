"""Bytes and operations of one windowed gauge evaluation (avg_over_time
through the aligned tiles, max_over_time through the packed gather), from
the query's shape alone: every sample of the configuration's data that
some window of the call covers, read once (12 bytes: its time and its f64
value), and one f64 answer per series, grid and step; two operations a
sample.

A call is described by its parts, each `(rows, grids)`: `rows` series
that hold samples, each evaluating every grid `(first window start, first
window end, step, steps)` of the part, both window ends inclusive. The
shapes are the query's: the series it selected and the steps it asked
for, not the rows and steps the program pads its tensors to.

`probes()` names the program functions whose calls are counted, and how
each call's arguments give its parts.
"""

from portbench.harness.devtrace import Probe

GATHER_FUNCS = ("min_over_time", "max_over_time", "quantile_over_time")


def data_span(cfg: dict):
    """(first, last) nominal sample time in ms of the configuration's
    data."""
    n = cfg["flushed_samples"] + cfg.get("tail_samples", 0)
    return cfg["start_ms"], cfg["start_ms"] + (n - 1) * cfg["interval_ms"]


def covered_samples(grids, cfg: dict) -> int:
    """Samples of one series, on the configuration's lattice of sample
    times and inside its data, that the union of the grids' windows
    covers."""
    first, last = data_span(cfg)
    dt = cfg["interval_ms"]
    spans = sorted((max(a + k * step, first), min(b + k * step, last))
                   for a, b, step, steps in grids for k in range(steps))
    total, cur = 0, None

    def count(a, b):
        # lattice points first + j * dt inside [a, b]
        return max(0, (b - first) // dt - -(-(a - first) // dt) + 1)

    for a, b in spans:
        if b < a:
            continue
        if cur is not None and a <= cur[1]:
            cur[1] = max(cur[1], b)
            continue
        if cur is not None:
            total += count(*cur)
        cur = [a, b]
    if cur is not None:
        total += count(*cur)
    return total


def call_bytes_ops(call: dict, cfg: dict):
    """(bytes, operations) of one recorded call."""
    n = out = 0
    for rows, grids in call["parts"]:
        n += rows * covered_samples(grids, cfg)
        out += rows * sum(g[3] for g in grids)
    return n * 12 + out * 8, 2 * n


def _real_rows(lens) -> int:
    """Rows of a packed tile that hold samples (pad rows hold none)."""
    return int((lens > 0).sum())


def _aligned(args, kwargs, out, ctx):
    tiles, func, steps, window_ms = args[:4]
    off = args[4] if len(args) > 4 else kwargs.get("offset_ms", 0)
    w0e = int(steps[0]) - int(off)
    step = int(steps[1] - steps[0]) if steps.size > 1 else 1
    return {"parts": [(len(tiles.keys), [(w0e - int(window_ms), w0e, step,
                                          int(steps.size))])]}


def _aligned_batch(args, kwargs, out, ctx):
    tiles, func, nsteps, step, w0s, w0e = args[:6]
    return {"parts": [(len(tiles.keys), [(int(a), int(b), int(step),
                                          int(nsteps))
                                         for a, b in zip(w0s, w0e)])]}


def _packed_single(args, kwargs):
    # (self, func, ts, vals, lens, w0s, w0e, step, nsteps, ...): the
    # query's own rows and steps, before the series and step buckets
    _, func, ts, vals, lens, w0s, w0e, step, nsteps = args[:9]
    if func not in GATHER_FUNCS:
        return None
    return {"parts": [(_real_rows(lens), [(int(w0s), int(w0e), int(step),
                                           int(nsteps))])]}


def _packed_batch(args, kwargs):
    # (self, func, t_bucket, scalar, members): a batch of one runs
    # _packed_single, which describes itself
    _, func, _, _, members = args[:5]
    if func not in GATHER_FUNCS or len(members) < 2:
        return None
    return {"parts": [(_real_rows(m.lens), [(int(m.w0s), int(m.w0e),
                                             int(m.step), int(m.nsteps))])
                      for m in members]}


def _gather(args, kwargs, out, ctx):
    return None if ctx is None else {"parts": ctx["parts"]}


def probes():
    tst = "filodb_tpu_torch.query.tilestore"
    be = "filodb_tpu_torch.query.backend"
    return [Probe(f"{tst}:evaluate_aligned", _aligned),
            Probe(f"{tst}:evaluate_aligned_batch", _aligned_batch),
            Probe(f"{be}:TorchBackend._packed_single", _packed_single,
                  context=True),
            Probe(f"{be}:TorchBackend._packed_run_inner", _packed_batch,
                  context=True),
            Probe(f"{be}:_window_gather", _gather)]
