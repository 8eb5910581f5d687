"""``launches_per_step.<kind>[.<regime>]``: the kernels the card ran in
the traced window (copies and memsets left out) over the window's steps
or calls: an exact count, since the window holds whole steps."""


def read(name, ctx):
    trace = ctx["trace"]
    if name.split(".")[1:2] != [ctx["kind"]] or not trace.device_events:
        return None
    return trace.kernel_count() / ctx["steps"]
