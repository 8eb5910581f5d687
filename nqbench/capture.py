"""What a training cell's set-up reads of its first steps, through the
window's own call: for each optimizer the program creates, in order, its
leaves before the first step, the first gradient as Adam got it (its
first moment after one step over 1 - beta1) and the leaves after the third
step; optionally the leaves after a given step. Global optimizer hooks,
removed before the window opens; each reading is a copy on the card, with
no synchronise."""

from __future__ import annotations

import torch
import torch.optim.optimizer as _optim


def _leaves(opt):
    return [p for g in opt.param_groups for p in g["params"]]


class Steps:
    def __init__(self, last: dict | None = None):
        self.opts, self.count = [], []
        self.before, self.grad, self.after3, self.at = [], [], [], {}
        self.last = last or {}      # optimizer index -> step to copy after
        self._pre = _optim.register_optimizer_step_pre_hook(self._pre_hook)
        self._post = _optim.register_optimizer_step_post_hook(
            self._post_hook)

    def _index(self, opt) -> int:
        for i, o in enumerate(self.opts):
            if o is opt:
                return i
        self.opts.append(opt)
        self.count.append(0)
        self.before.append(None)
        self.grad.append(None)
        self.after3.append(None)
        return len(self.opts) - 1

    @torch.no_grad()
    def _pre_hook(self, opt, args, kwargs):
        i = self._index(opt)
        if self.count[i] == 0:
            self.before[i] = [p.detach().clone() for p in _leaves(opt)]

    @torch.no_grad()
    def _post_hook(self, opt, args, kwargs):
        i = self._index(opt)
        self.count[i] += 1
        n = self.count[i]
        if n == 1:
            b1 = opt.param_groups[0]["betas"][0]
            self.grad[i] = [opt.state[p]["exp_avg"].clone() / (1.0 - b1)
                            for p in _leaves(opt)]
        if n == 3:
            self.after3[i] = [p.detach().clone() for p in _leaves(opt)]
        if self.last.get(i) == n:
            self.at[i] = [p.detach().clone() for p in _leaves(opt)]

    def remove(self):
        self._pre.remove()
        self._post.remove()

    def readings(self, i: int, names, losses) -> dict:
        """Optimizer i's first steps by leaf name: {"loss": [...], "grad",
        "change", "start"}."""
        if self.after3[i] is None:
            raise RuntimeError(f"optimizer {i} made fewer than 3 steps")
        return {"loss": [float(x) for x in losses],
                "start": dict(zip(names, self.before[i])),
                "grad": dict(zip(names, self.grad[i])),
                "change": {k: a - b for k, a, b in zip(
                    names, self.after3[i], self.before[i])}}
