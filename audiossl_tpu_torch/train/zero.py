"""ZeRO-sharded optimizer state over the data axis (port of
``audiossl_tpu.train.zero``, ``run.zero_optimizer``).

The parameters stay whole on every rank; the optimizer's state is 1/n per
rank (ZeRO-1/2):

* every parameter is flattened, zero-padded to n·k elements and viewed as
  [n, k] (``shard_rows``); rank r owns row r (``local_slice``), in the
  port's own layout (a Linear weight flattens [out, in]-major: the
  converter below carries JAX's rows across);
* the gradients are reduce-scattered as the data axis's mean, every
  parameter's rows in one flat buffer ("zero_reduce_scatter"), in place of
  the data-parallel all-reduce (JAX ``psum_scatter(tiled) / n``);
* the wrapped torch optimizer (SGD, Adam or AdamW: elementwise, so a slice
  updates as it would inside the whole tensor) steps one flat k-slice per
  parameter, so its moments are [k] and its parameter groups (a
  weight-decay mask, say) survive; each step takes the slices afresh from
  the parameters, as JAX's ``slice_param`` does;
* the new slices are all-gathered in one flat buffer ("zero_all_gather")
  and written back into the whole parameters.

The optimizer's state_dict holds JAX's layout: each moment [n, k] (every
rank's row, gathered), and the world it was saved at; a resume at another
world raises, as JAX's restore of a ``P(DATA_AXIS)`` state of another
length does (zero.py:25-27). LARS and LARC read whole-tensor norms and are
refused (``assert_zero_compatible``, JAX's message). With one process the
collectives are the identity and the step is the plain optimizer's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable

import numpy as np
import torch

from audiossl_tpu_torch.parallel import dist

# optimizers whose update math is elementwise per parameter entry
ELEMENTWISE_OPTIMIZERS = ("sgd", "adam", "adamw")


def assert_zero_compatible(opt_name: str) -> None:
    if opt_name.lower() not in ELEMENTWISE_OPTIMIZERS:
        raise ValueError(
            f"zero_optimizer supports elementwise optimizers {ELEMENTWISE_OPTIMIZERS}; "
            f"{opt_name!r} needs full-tensor norms (trust ratio) which a sharded "
            "slice cannot see"
        )


def shard_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    """``a`` flattened and zero-padded to [n, ceil(size / n)]: row i is rank i's slice."""
    k = -(-a.numel() // n)
    flat = a.reshape(-1)
    return torch.cat([flat, flat.new_zeros(n * k - flat.numel())]).view(n, k)


def local_slice(a: torch.Tensor, n: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s row of ``shard_rows(a, n)``."""
    return shard_rows(a, n)[rank]


class ZeroOptimizer:
    """A torch optimizer over flat slices of ``params`` (built by
    ``build_inner(slices)``), stepped ZeRO's way; ``zero_grad``, ``step``,
    ``state_dict`` and ``load_state_dict`` as an optimizer's (a scheduler
    steps the inner optimizer)."""

    def __init__(self, params: Iterable[torch.Tensor], build_inner: Callable[[list[torch.Tensor]], Any]):
        self.params = list(params)
        self.n, self.rank = dist.dp_world(), dist.dp_rank()
        with torch.no_grad():
            self.slices = [torch.nn.Parameter(local_slice(p.detach(), self.n, self.rank).clone()) for p in self.params]
        self.ks = [s.numel() for s in self.slices]
        self.inner = build_inner(self.slices)

    def grads_to_all_reduce(self, params: Iterable[torch.Tensor]) -> list[torch.Tensor]:
        """None: ``step`` reduce-scatters every gradient itself."""
        return []

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Every gradient to None (the parameters' and the slices')."""
        for p in self.params + self.slices:
            p.grad = None

    @torch.no_grad()
    def step(self, closure=None):
        """Reduce-scatter the gradients, update this rank's slices, gather
        the parameters; a parameter the loss did not reach counts as a zero
        gradient (JAX's gradient tree holds zeros there)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        rows = torch.cat([shard_rows(g, self.n) for g in grads], dim=1)  # [n, K]
        mine = dist.reduce_scatter_mean(rows.reshape(-1), "zero_reduce_scatter")
        for p, s, g in zip(self.params, self.slices, mine.split(self.ks)):
            s.copy_(local_slice(p, self.n, self.rank))
            s.grad = g.to(s.dtype)
        self.inner.step()
        whole = dist.all_gather_flat(torch.cat([s.reshape(-1) for s in self.slices]), "zero_all_gather")
        whole = whole.view(self.n, -1)
        off = 0
        for p, k in zip(self.params, self.ks):
            p.copy_(whole[:, off:off + k].reshape(-1)[:p.numel()].view_as(p))
            off += k
        return None

    def _moments(self, sd: dict) -> list[tuple[int, str]]:
        return [(i, k) for i, st in sd["state"].items() for k, v in st.items() if torch.is_tensor(v) and v.dim() > 0]

    def state_dict(self) -> dict:
        """The inner optimizer's state_dict with each moment [n, k], every
        rank's row in order (a collective: one gather), and ``zero_world``."""
        sd = self.inner.state_dict()
        slots = self._moments(sd)
        state = {i: dict(st) for i, st in sd["state"].items()}
        if slots:
            flat = torch.cat([sd["state"][i][k].reshape(-1) for i, k in slots])
            rows = dist.all_gather_flat(flat, "zero_state_gather").view(self.n, -1)
            off = 0
            for i, k in slots:
                m = sd["state"][i][k].numel()
                state[i][k] = rows[:, off:off + m].clone()
                off += m
        return {**sd, "state": state, "zero_world": self.n}

    def load_state_dict(self, sd: dict) -> None:
        """This rank's rows of a saved state; raises for another world size."""
        world = int(sd["zero_world"])
        if world != self.n:
            raise ValueError(f"the checkpoint holds ZeRO optimizer state sharded over {world} process(es), this run "
                             f"has {self.n}: resume at the world size it was saved at (JAX's restore refuses too)")
        state = {i: {k: v[self.rank] if torch.is_tensor(v) and v.dim() > 1 else v for k, v in st.items()}
                 for i, st in sd["state"].items()}
        self.inner.load_state_dict({k: v for k, v in {**sd, "state": state}.items() if k != "zero_world"})


def build_zero_optimizer(name: str, params: Iterable[torch.Tensor], lr, **kw):
    """(ZeroOptimizer, scheduler or None): ``train.optim.build_optimizer``'s
    optimizer ``name`` over this rank's slices of ``params``; raises for an
    optimizer that is not elementwise."""
    from audiossl_tpu_torch.train.optim import build_optimizer

    assert_zero_compatible(name)
    built = {}

    def inner(slices):
        built["opt"], built["sched"] = build_optimizer(name, slices, lr, **kw)
        return built["opt"]

    return ZeroOptimizer(params, inner), built["sched"]


def rank_state_from_rows(rows: list[dict[str, np.ndarray]], count: int, rank: int,
                         names: dict[str, str]) -> dict[int, dict[str, torch.Tensor]]:
    """Rank ``rank``'s inner optimizer state from JAX's ``zero_init`` layout:
    ``rows[i]`` maps a moment's optax name (``mu``, ``nu``, ``trace``) to
    the [n, k] rows of parameter i (carried to the port's layout), ``count``
    is the update count, ``names`` maps optax names to torch's (``mu`` ->
    ``exp_avg``, ``nu`` -> ``exp_avg_sq``, ``trace`` -> ``momentum_buffer``).
    Adam's ``step`` is the count as an f32 scalar tensor (torch's layout)."""
    out = {}
    for i, moments in enumerate(rows):
        st: dict[str, Any] = {names[k]: torch.from_numpy(np.ascontiguousarray(v[rank])) for k, v in moments.items()}
        if "exp_avg" in st:
            st["step"] = torch.tensor(float(count))
        out[i] = st
    return out
