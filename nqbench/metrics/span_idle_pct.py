"""``span_idle_pct.<kind>[.<regime>].<layer>``: the card's idle time
between consecutive intervals of the traced window (no kernel, copy or
memset running) while the host was in the program's span `<layer>`, a
child of the decode call's or the training step's root span, as a share
of the traced window, in % (``nqbench/span_split.py``). The layers' sum is
at most ``device_idle_pct``, which also counts the window's edges and the
gaps outside every child. None where the program records no spans."""

from nqbench import span_split


def read(name, ctx):
    parts = name.split(".")
    if parts[1] != ctx["kind"]:
        return None
    got = span_split.split(ctx)
    if got is None or parts[-1] not in got["layers"]:
        return None
    return 100.0 * got["idle_ns"][parts[-1]] / 1e9 / ctx["window_s"]
