"""``span_launches_per_step.<kind>[.<regime>].<layer>``: the host's kernel
launch calls (the runtime events ``cudaLaunchKernel*`` and
``cuLaunchKernel*``) that start inside the program's span `<layer>`, a
child of the decode call's or the training step's root span, over the
traced window's steps or calls (``nqbench/span_split.py``). The layers'
sum against ``launches_per_step`` says how much of the step the spans
cover. None where the program records no spans."""

from nqbench import span_split


def read(name, ctx):
    parts = name.split(".")
    if parts[1] != ctx["kind"]:
        return None
    got = span_split.split(ctx)
    if got is None or parts[-1] not in got["layers"]:
        return None
    return got["launches"][parts[-1]] / ctx["steps"]
