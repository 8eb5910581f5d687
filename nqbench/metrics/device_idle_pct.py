"""``device_idle_pct.<kind>[.<regime>]``: the share of the traced window
in which no kernel, copy or memset ran on the card, in %: 1 minus the
union of the card's intervals over the window's wall time. Read in the
cells whose driver is <kind>; a third part of the name (``host_paced``)
keeps the bound of the end-to-end metric it moves apart. The profiler
adds host time to every launch, so in a host-paced cell this is an upper
reading."""


def read(name, ctx):
    trace = ctx["trace"]
    if name.split(".")[1:2] != [ctx["kind"]] or not trace.device_events:
        return None
    return 100.0 * (1.0 - trace.busy_s() / ctx["window_s"])
