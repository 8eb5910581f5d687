"""Faults planted in the program under a run, each of which the cell's
comparison must catch (``correct`` false):

- ``answer``: a decode's output altered where it is produced (one pixel
  of every frame moved by 1/255);
- ``frozen``: a training step that returns its state unchanged (Adam's
  step puts the leaves back as they were);
- ``half_batch``: half of each step's batch left out, the loss the mean
  over the rest.
"""

from __future__ import annotations

import torch


def plant(name: str, cell) -> None:
    if name == "none":
        return
    if name == "answer":
        from neuroquant_tpu_torch.models.decoder import NeRVDecoder

        decode = NeRVDecoder.decode

        def altered(self, *a, **k):
            y = decode(self, *a, **k)
            y = y.clone()
            y[:, 0, 0, 0] += 1.0 / 255.0
            return y
        NeRVDecoder.decode = altered
    elif name == "frozen":
        step = torch.optim.Adam.step

        def frozen(self, closure=None):
            leaves = [p for g in self.param_groups for p in g["params"]]
            with torch.no_grad():
                kept = [p.clone() for p in leaves]
            out = step(self, closure)
            with torch.no_grad():
                for p, k in zip(leaves, kept):
                    p.copy_(k)
            return out
        torch.optim.Adam.step = frozen
    elif name == "half_batch":
        from neuroquant_tpu_torch.quantization import calibrate

        make_loss = calibrate.make_loss

        def halved(*a, **k):
            loss = make_loss(*a, **k)

            def fn(state, img, inputs, count, **kw):
                h = max(1, img.shape[0] // 2)
                return loss(state, img[:h], inputs[:h], count, **kw)
            return fn
        calibrate.make_loss = halved
    else:
        raise ValueError(f"unknown fault {name!r}")
