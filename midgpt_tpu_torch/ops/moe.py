"""The routed MLP's combine product as one op (the einsum "btef,edf->btd"
of midgpt_tpu/models/gpt.py `GPT._moe_mlp`).

`moe_down(up, down)`: the gated expert activations up (N, E, F) and the
expert bank down (E, D, F) -> (N, D), sum_e up[:, e] @ down[e].T. One
matrix product over (e, f) would need the bank as an (E*F, D) matrix,
which its (E, D, F) layout does not give as a view: every call would copy
the whole bank (37.7 MB a layer in bf16 at GPT-2 small's width). Here the
bank is read in place: one batched product over E, (E, N, F) @ (E, F, D),
both operands strided views, then the sum over E (accumulated in f32 for
bf16 and rounded once). The backward is two batched products over the
same views.

It is one custom op so that a remat policy can keep its output whole, as
JAX's `dots_with_no_batch_dims_saveable` keeps the combine einsum (it has
no batch dimension): a dispatch mode sees `midgpt::moe_down`, where the
batched product inside it would look like naive attention's, which the
policies recompute (ops/remat.py)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


@torch.library.custom_op("midgpt::moe_down", mutates_args=())
def moe_down(up: Tensor, down: Tensor) -> Tensor:
    """(N, E, F), (E, D, F) -> (N, D): sum_e up[:, e] @ down[e].T."""
    return torch.bmm(up.transpose(0, 1), down.transpose(1, 2)).sum(0)


@moe_down.register_fake
def _(up: Tensor, down: Tensor) -> Tensor:
    return up.new_empty(up.shape[0], down.shape[1])


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, g: Tensor):
    up, down = ctx.saved_tensors
    E, N, D = down.shape[0], g.shape[0], g.shape[1]
    g_up = torch.bmm(g.expand(E, N, D), down).transpose(0, 1)  # (N, E, F)
    g_down = torch.bmm(g.t().expand(E, D, N), up.transpose(0, 1))  # (E, D, F)
    return g_up, g_down


moe_down.register_autograd(_backward, setup_context=_setup_context)
