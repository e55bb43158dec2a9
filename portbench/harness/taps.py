"""What one pass of the program hands across a few of its module
boundaries, for the stage numbers of the output check.

A configuration's ``stages`` name, each, the module whose forward's first
argument is the stage's input (``input_of``) and the module whose result
(``output_of``) or whose forward's first argument (``output_to``) is the
stage's output, as paths under the encoder. Within the first ``with
Taps(stages, encoder):`` forward hooks keep a copy of the first such tensor
of each; a stage whose modules were not called in that pass has no reading.
"""
from __future__ import annotations

import torch


class Taps:
    def __init__(self, stages: list[dict], root: torch.nn.Module):
        self.stages, self.root = stages, root
        self.captured: dict[tuple[str, str], torch.Tensor] = {}
        self._handles = []

    def _keep(self, key: tuple[str, str], t) -> None:
        if key not in self.captured and isinstance(t, torch.Tensor):
            self.captured[key] = t.detach().clone()

    def __enter__(self) -> "Taps":
        if self.root is None:  # the pass was made
            return self
        wanted = set()
        for st in self.stages:
            wanted.add(("input_of", st["input_of"]))
            wanted.add(("output_of", st["output_of"]) if "output_of" in st else ("output_to", st["output_to"]))
        for kind, path in sorted(wanted):
            module = self.root.get_submodule(path)
            if kind == "output_of":
                hook = lambda m, args, out, key=(kind, path): self._keep(key, out)  # noqa: E731
                self._handles.append(module.register_forward_hook(hook))
            else:
                hook = lambda m, args, key=(kind, path): self._keep(key, args[0] if args else None)  # noqa: E731
                self._handles.append(module.register_forward_pre_hook(hook))
        return self

    def __exit__(self, *exc) -> None:
        for h in self._handles:
            h.remove()
        self._handles.clear()
        self.root = None  # the program's modules are not kept alive past the pass

    def pair(self, stage: dict) -> tuple[torch.Tensor, torch.Tensor] | None:
        """(the stage's input, its output) as the program made them, or None."""
        out_key = ("output_of", stage["output_of"]) if "output_of" in stage else ("output_to", stage["output_to"])
        x, y = self.captured.get(("input_of", stage["input_of"])), self.captured.get(out_key)
        return None if x is None or y is None else (x, y)
