"""``span_card_ms.<kind>[.<regime>].<layer>``: the card's time in the
kernels, copies and memsets launched while the host was in the program's
span `<layer>`, a child of the decode call's or the training step's root
span, summed over the traced window and divided by its steps or calls, in
ms (``nqbench/span_split.py``). Each operation is joined to the runtime
or driver call that launched it by their correlation id and goes to the
child open when that call started, on whatever thread: a launch on
autograd's thread during ``backward`` counts to ``backward``. Operations
launched outside every child, or joined to no call, go to no layer (the
result line's ``window.card_rest_ms``; ``window.card_matched_pct`` is the
share joined). None where the program records no spans."""

from nqbench import span_split


def read(name, ctx):
    parts = name.split(".")
    if parts[1] != ctx["kind"]:
        return None
    got = span_split.split(ctx)
    if got is None or parts[-1] not in got["layers"]:
        return None
    return got["card_ns"][parts[-1]] / 1e6 / ctx["steps"]
