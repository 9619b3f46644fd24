"""Per-block rematerialization with the JAX package's four policies
(counterpart of `jax.checkpoint(block_fn, policy=_remat_policy(...))`,
midgpt_tpu/models/gpt.py:483-508,1036-1037).

`checkpoint_block(fn, x, policy, generator)` runs one block `fn(x)` (its
output a tensor, or a tuple of them: the block and its MoE aux term) under
`torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`: the backward
recomputes the block from its input, except the ops the policy keeps,
whose outputs the recompute takes from the forward instead of running
them again. The policies keep, beside the block input:

  none       nothing;
  dots       the projection products, `aten.mm` / `aten.addmm` (QKV, wo,
             w_up, w_down; the routed MLP's router and experts_up), and its
             combine product `midgpt::moe_down` (ops/moe.py): JAX's
             dots_with_no_batch_dims_saveable. The batched `bmm` of naive
             and blockwise attention is recomputed, and so is the flash
             forward kernel;
  dots_attn  dots, plus the attention output: the flash forward op's out
             and lse (`midgpt::flash_fwd`, so the backward never launches
             the forward kernel again), or the tensor named "attn_out" on
             the naive and blockwise paths;
  flash      dots_attn, plus the tensors named "q_rot", "k_rot" and
             "v_proj" (the rotated q and k, and v, as the attention takes
             them).

A name is JAX's `checkpoint_name`: `name(t, "q_rot", policy)` passes `t`
through the `midgpt::checkpoint_name` op (a copy) when the policy keeps
that name, and returns `t` itself otherwise. Eager PyTorch recomputes the
block's code in order, so a kept output spares the op that made it, not
the ops that fed it: under "flash" the rotation still runs in the
recompute (its norms' own saved tensors are needed anyway), and the
names only add what they hold.

The kept outputs are recorded by a dispatch mode in the forward and
replayed, in order, by another in the recompute (each replay checks it
stands where the forward's op stood). They are held by an autograd node
after the block (`_Keep`), so saved-tensor hooks see them as they see any
saved activation, and they are freed with the graph. Every output of the
block passes through that node, so the backward reaches it, and hands it
the kept outputs, before any gradient enters the block.

Under tensor parallelism (parallel/tp.py) the block's collectives are
ordinary ops to these modes: the recompute runs Megatron's g (an
all-reduce forward) again, on every rank of the row at the same point of
the backward, and f's all-reduce stays in the backward. `dots` keeps the
row-parallel products (wo, w_down) before g, as `aten.mm` outputs: the
partial sums, which the recompute's g sums over the row again.

Dropout draws from an explicit `torch.Generator` (ops/dropout.py), whose
state torch.utils.checkpoint does not keep (it keeps the default
generators'): the forward mode records the generator's state at the
block's entry, and the recompute sets it back and restores the state it
found afterwards, so the recompute draws the forward's masks.
"""

from __future__ import annotations

import typing as tp

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from midgpt_tpu_torch.kernels.flash_attention import flash_fwd_op  # noqa: F401 (registers midgpt::flash_fwd)
from midgpt_tpu_torch.ops.moe import moe_down  # noqa: F401 (registers midgpt::moe_down)

Tensor = torch.Tensor

POLICY_NAMES: tp.Dict[str, tp.FrozenSet[str]] = {
    "none": frozenset(),
    "dots": frozenset(),
    "dots_attn": frozenset({"attn_out"}),
    "flash": frozenset({"q_rot", "k_rot", "v_proj", "attn_out"}),
}


@torch.library.custom_op("midgpt::checkpoint_name", mutates_args=())
def checkpoint_name_op(x: Tensor, name: str) -> Tensor:
    """A named copy of `x` that a remat policy can keep (an op's output may
    not alias its input)."""
    return x.clone()


checkpoint_name_op.register_autograd(lambda ctx, g: (g, None))


def name(t: Tensor, tag: str, policy: tp.Optional[str]) -> Tensor:
    """`t` named `tag` for `policy` (a copy the policy keeps), or `t`
    itself when there is no policy or it does not keep `tag`."""
    if policy is None or tag not in POLICY_NAMES[policy]:
        return t
    return checkpoint_name_op(t, tag)


# the products without a batch dimension (JAX's dots_with_no_batch_dims_saveable)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.midgpt.moe_down.default)
_FLASH_FWD = torch.ops.midgpt.flash_fwd.default
_NAME = torch.ops.midgpt.checkpoint_name.default


def _keeps(policy: str, func) -> bool:
    if policy == "none":
        return False
    if func in _DOTS:
        return True
    return policy != "dots" and (func is _FLASH_FWD or func is _NAME)


def _detached(out):
    return tuple(t.detach() for t in out) if isinstance(out, (tuple, list)) else out.detach()


class _Store:
    """What one block's forward keeps for its recompute: (op, outputs) in
    forward order, and the dropout generator's state at the block's entry."""

    def __init__(self, policy: str, generator: tp.Optional[torch.Generator]):
        self.policy, self.generator = policy, generator
        self.kept: tp.List[tp.Tuple[tp.Any, tp.Any]] = []
        self.gen_state: tp.Optional[Tensor] = None


class _Record(TorchDispatchMode):
    """The forward: runs every op and records the kept ones' outputs."""

    def __init__(self, store: _Store):
        super().__init__()
        self.store = store

    def __enter__(self):
        if self.store.generator is not None:
            self.store.gen_state = self.store.generator.get_state()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _keeps(self.store.policy, func):
            self.store.kept.append((func, _detached(out)))
        return out


class _Replay(TorchDispatchMode):
    """The recompute: returns the kept ops' recorded outputs in forward
    order and runs every other op, with the dropout generator set back to
    its state at the block's entry (and restored on exit)."""

    def __init__(self, store: _Store):
        super().__init__()
        self.store = store
        self._next = 0
        self._found: tp.Optional[Tensor] = None

    def __enter__(self):
        gen = self.store.generator
        if gen is not None:
            self._found = gen.get_state()
            gen.set_state(self.store.gen_state)
        self._next = 0
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self.store.generator is not None:
                self.store.generator.set_state(self._found)
            self.store.kept = []  # the recompute's graph holds what it used

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not _keeps(self.store.policy, func):
            return func(*args, **(kwargs or {}))
        if self._next >= len(self.store.kept) or self.store.kept[self._next][0] is not func:
            raise RuntimeError(
                f"remat recompute reached {func} where the forward kept "
                f"{self.store.kept[self._next][0] if self._next < len(self.store.kept) else 'nothing'}: "
                "the block's forward must run the same ops each time"
            )
        out = self.store.kept[self._next][1]
        self._next += 1
        return _detached(out)


class _Keep(torch.autograd.Function):
    """Identity on the block's `n` outputs that holds the kept outputs as
    saved tensors until the backward reaches the block, then hands them to
    its recompute."""

    @staticmethod
    def forward(ctx, store: _Store, n: int, *tensors: Tensor) -> tp.Tuple[Tensor, ...]:
        ctx.store, ctx.n = store, n
        ctx.layout = [(func, isinstance(out, tuple), len(out) if isinstance(out, tuple) else 1)
                      for func, out in store.kept]
        store.kept = []
        ctx.save_for_backward(*tensors[n:])
        return tuple(t.view_as(t) for t in tensors[:n])

    @staticmethod
    def backward(ctx, *grads: Tensor):
        flat, kept, i = ctx.saved_tensors, [], 0
        for func, is_tuple, n in ctx.layout:
            kept.append((func, tuple(flat[i:i + n]) if is_tuple else flat[i]))
            i += n
        ctx.store.kept = kept
        return (None, None) + grads + (None,) * len(flat)


def checkpoint_block(
    fn: tp.Callable[[Tensor], tp.Union[Tensor, tp.Tuple[Tensor, ...]]],
    x: Tensor,
    policy: str,
    generator: tp.Optional[torch.Generator] = None,
) -> tp.Union[Tensor, tp.Tuple[Tensor, ...]]:
    """`fn(x)` with its activations rematerialized in the backward under
    `policy` (module docstring). `generator` is the dropout generator `fn`
    draws from, or None."""
    if policy not in POLICY_NAMES:
        raise ValueError(f"unknown remat_policy {policy!r} (expected 'none', 'dots', 'dots_attn' or 'flash')")
    store = _Store(policy, generator)
    out = checkpoint(
        fn, x, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (_Record(store), _Replay(store)),
    )
    if not store.kept:
        return out
    outs = out if isinstance(out, tuple) else (out,)
    flat = [t for _, o in store.kept for t in (o if isinstance(o, tuple) else (o,))]
    kept = _Keep.apply(store, len(outs), *outs, *flat)
    return kept if isinstance(out, tuple) else kept[0]
