"""``mfu_pct.<kind>[.<regime>]``: the useful FLOPs of every decode or
step of the timed window (``nqbench/work``, from the configuration's
shapes) over the window's wall time, as a share of the card's peak for
the work's precision (fp32 work: the TF32 tensor-core peak, 495 TFLOP/s),
in %. Read in the untraced window that precedes the traced one, since the
profiler slows a host-paced step; the trace only shows that the card
ran."""

from nqbench import core


def read(name, ctx):
    work = ctx["work"]
    if (name.split(".")[1:2] != [ctx["kind"]]
            or not ctx["trace"].device_events or not work.get("flops")):
        return None
    rate = work["flops"] * ctx["timed_steps"] / ctx["timed_s"]
    return 100.0 * rate / core.PEAK_FLOPS["float32"]
