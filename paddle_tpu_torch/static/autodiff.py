"""Program-level autodiff: ``append_backward`` / ``gradients`` (counterpart
of paddle_tpu/static/autodiff.py).

As in the JAX package the backward is ONE grad super-op appended to the
program.  Its body replays the recorded forward prefix (the ops the loss
needs, last writer wins) with grad enabled on the values of the feeds and
state, and calls ``torch.autograd.grad`` where the JAX package calls
``jax.value_and_grad``.  Its outputs are the gradients, then the loss,
then the last value of each state the forward writes (the RNG state that
its dropouts advance).  The loss var and those state vars are re-bound to
these outputs by alias ops (``share_loss``, ``share_state``), so a fetch
of the loss and the program's writes read the grad op, and the
Executor's last-writer-wins prune drops the recorded forward: a training
run executes the forward once.  The grad op closes over a snapshot of
the unfused forward (``grad_meta`` records what rebuilds it), so the
fusion pass's rewrites of the recorded forward do not reach it.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils import _pytree as pytree

from .program import Operator, Program, Variable, current_main_program, prune_ops

__all__ = ["append_backward", "gradients"]


def build_grad_fn(prog: Program, target_vid, wrt_vids, in_vids, state_out_vids=(), ops=None):
    """``fn(*values of in_vids) -> (grads..., loss, state outs...)``: the
    gradients of the target (summed, if not a scalar) with respect to
    ``wrt_vids`` over the program's current op list, or ``ops``."""
    outs = [target_vid, *state_out_vids]
    ops = prune_ops(prog.global_block().ops if ops is None else ops, outs)
    run_fn, _, _ = prog.as_function(outs, feed_vids=[], state_vids=in_vids, ops=ops)
    wrt_pos = [in_vids.index(vid) for vid in wrt_vids]

    def fn(*vals):
        full = list(vals)
        with torch.enable_grad():
            leaves = []
            for pos in wrt_pos:
                leaf = vals[pos].detach().requires_grad_(True)
                full[pos] = leaf
                leaves.append(leaf)
            (out, *states), _ = run_fn([], full)
            loss = out.sum() if out.dim() else out
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(leaf) if g is None else g for g, leaf in zip(grads, leaves)]
        return tuple(grads) + (loss.detach(),) + tuple(s.detach() for s in states)

    return fn


def _identity(v):
    return v


def _alias(prog, type_, src, dst_vid):
    """Re-bind ``dst_vid`` to the value of Variable ``src``."""
    prog.global_block().ops.append(Operator(type_, _identity, [("var", src._vid)], {},
                                            [dst_vid], pytree.tree_structure(src)))
    prog.version += 1


def _grad_superop(prog: Program, target: Variable, wrt_vars, name):
    """Record one op computing d(target)/d(wrt_vars); returns the grad
    Variables."""
    inputs = list(prog.feed_vars) + [prog._var_by_vid[vid] for vid in prog.param_inits]
    in_vids = [v._vid for v in inputs]
    wrt_vids = [v._vid for v in wrt_vars]
    # the forward's last value of each state it writes (the RNG state):
    # the grad op computes it, so the recorded forward can drop
    state_outs = [src for src in dict.fromkeys(prog.writes.values()) if src not in in_vids]
    fn = build_grad_fn(prog, target._vid, wrt_vids, in_vids, state_outs)
    metas = ([torch.empty(v.shape, dtype=v.dtype, device="meta") for v in wrt_vars]
             + [torch.empty((), dtype=target.dtype, device="meta")]
             + [torch.empty(prog._var_by_vid[s].shape, dtype=prog._var_by_vid[s].dtype,
                            device="meta") for s in state_outs])
    outs = list(prog.record(name, fn, tuple(inputs), {}, out_meta=tuple(metas)))
    op = prog.global_block().ops[-1]
    op.impl = None  # a closure over the forward: rebuilt from grad_meta, not from data
    op.grad_meta = {"target_vid": target._vid, "wrt_vids": wrt_vids, "in_vids": in_vids,
                    "state_out_vids": state_outs}
    n = len(wrt_vars)
    grads, loss_out, state_vals = outs[:n], outs[n], outs[n + 1:]
    _alias(prog, "share_loss", loss_out, target._vid)
    for src, val in zip(state_outs, state_vals):
        _alias(prog, "share_state", val, src)
    return grads


def append_backward(loss, parameter_list=None, no_grad_set=None):
    """Returns ``[(parameter Variable, grad Variable)]``.  ``parameter_list``
    may hold ``nn.Parameter``s (registered as state vars) or Variables;
    by default every parameter the program holds."""
    prog = current_main_program()
    if prog is None:
        raise RuntimeError("append_backward requires an active program_guard")
    if parameter_list:
        wrt = []
        for p in parameter_list:
            if isinstance(p, Variable):
                wrt.append(p)
            elif isinstance(p, nn.Parameter):
                wrt.append(prog.var_for_parameter(p))
            else:
                raise TypeError(f"bad parameter {p!r}")
    else:
        wrt = prog.all_parameters()
    if no_grad_set:
        skip = {id(v) for v in no_grad_set}
        wrt = [v for v in wrt if id(v) not in skip]
    grads = _grad_superop(prog, loss, wrt, "grad")
    return list(zip(wrt, grads))


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """``paddle.static.gradients``: the grads of ``sum(targets)`` with
    respect to ``inputs`` (feeds, parameters or state vars)."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if len(targets) != 1:
        raise NotImplementedError("multiple targets: sum them first")
    if target_gradients is not None:
        raise NotImplementedError("target_gradients: scale the target first")
    pairs = append_backward(targets[0], parameter_list=list(inputs))
    return [g for _, g in pairs]
