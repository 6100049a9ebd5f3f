"""Pipeline parallelism over the latent self-attention stack.

Counterpart of ``perceiverio_pytorch_tpu/parallel/pipeline.py``: the depth
of a distinct-layer stack (flow's 24 self-attends in one block) is split
over the ``pipe`` axis of a ("data", "pipe") mesh, and microbatches stream
through the stages with the GPipe schedule, or with the circular
(interleaved) one, whose stages hold ``circ_repeats`` round-robin layer
groups each and whose microbatches cycle the ring that many times.

JAX runs the schedule as one SPMD program under ``shard_map``, the hop
between stages a ``lax.ppermute`` inside a ``lax.scan`` over the ticks.
Here a stage is a rank (one process per device, as every mesh of the port)
and the same tick loop (``_run``) runs eagerly on each: the stage's input
is chosen and its layers applied by ``_Stage.tick``, a function of the
stage index, and ``collectives.ring_hop`` hands each output to the next
stage with point-to-point sends.  Given an int S in place of the mesh
(``pipeline_spmd``, ``pipeline_layers(stages=S)``), the same loop runs the
S stages' ticks in one process and hands the outputs on by a list rotation,
so that the schedule can be held against the sequential stack where one
device cannot hold a pipe axis.

The autograd graph has the same hops on every rank, in the same order, so
that every hop's backward (a send back and a receive) meets its peer's:

  * every stage hops after every tick but the last, bubble ticks included;
    a bubble tick computes nothing and hands on what it received;
  * stage 0 keeps what it received in the graph with a zero gradient
    (``_Join``) where it takes a fresh microbatch instead (JAX:
    ``where(idx == 0, inject, state)``), and every stage's first state is
    joined to the pipeline's input, so that each hop's input requires a
    gradient on every rank alike;
  * the input and the parameters enter through one ``copy_to_many`` node,
    whose backward (the one all-reduce of the parameters' gradients) runs
    after every hop's.

The last stage's outputs reach every rank through ``reduce_from`` (JAX's
masked ``psum``): a replicated loss gives every rank the same gradient, so
its backward leaves that gradient as it is.  The microbatch's rows split
over the mesh's data axis when it divides them (``batch_axis``), gathered
back at the end, unless the caller split the batch over that axis already
(``collectives.global_batch``, the sharded Trainer's steps): then a rank's
rows are its own and every rank of a pipe group must hold the same ones.

Parameters come in two layouts.  ``stack_layer_params`` leaves [S, per,
...] (or [S, v, per, ...]) whole on every rank are replicated: each rank
uses its stage's slice, and the gradient of every slice is summed over the
pipe (and split data) axes, so that every rank ends with the whole
gradient, as JAX's transpose of the ``P("pipe")`` in-spec gives it.  Leaves
[1, per, ...] are this rank's stage (``pp_param_shardings(...)[k].shard``:
the memory-scaling route, each rank holding only its layers and their
optimizer moments): their gradients stay local, summed over split data.

Dropout draws its masks from seeds (the port's ``torch.Generator`` sites):
block ``b``, tick ``t`` and stage ``i`` of a schedule seeded ``s`` run
their j-th local layer with ``mix_seed(mix_seed(mix_seed(mix_seed(s, b), t),
i), j)`` (JAX folds keys in the same order), so two equal rows in
different microbatches draw different masks.

Under ``pipeline_layers(remat=True)`` each (tick, stage) stage body is a
checkpointed region of its own (``config.remat_call``), and no hop is
inside one: a region's recompute in the backward replays only the stage's
layers.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, List, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from perceiverio_pytorch_tpu_torch.config import Policy, remat_call
from perceiverio_pytorch_tpu_torch.ops.attention_dense import mix_seed
from perceiverio_pytorch_tpu_torch.parallel import collectives as cc
from perceiverio_pytorch_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    adopt_process_mesh,
    axis,
    join_group,
)

PIPE_AXIS = "pipe"

__all__ = ["PIPE_AXIS", "layer_stage_fn", "make_pipeline_mesh", "pipeline_layers",
           "pipeline_spmd", "pipelined_self_attends",
           "pp_param_shardings", "stack_layer_params", "unstack_layer_params",
           "unstack_layer_params_circular"]


def make_pipeline_mesh(n_stages: int, *, data: int = 1, devices=None, device="cuda"):
    """A (data, pipe) mesh of ``data * n_stages`` ranks, laid out row-major
    (JAX's ``reshape(data, n_stages)``): rank r is stage r % n_stages of
    data row r // n_stages.  ``devices``: the global ranks to take them
    from (default: the group's, in order); ``device`` as ``make_mesh``'s.

    The mesh becomes the data path's default (``training/data.py``'s
    ``process_slice``) unless this process made a (data, model) mesh
    first: rows split over the data axis only, so the stages of one pipe
    group read the same rows.
    """
    device, ranks = join_group(device, devices)
    need = data * n_stages
    if need > len(ranks):
        raise ValueError(f"pipeline mesh needs {need} devices, have {len(ranks)}")
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh(device.type, torch.tensor(ranks[:need]).reshape(data, n_stages),
                      mesh_dim_names=(DATA_AXIS, PIPE_AXIS))
    adopt_process_mesh(mesh)
    return mesh


def stack_layer_params(layer_params: dict, n_stages: int, circ_repeats: int = 1):
    """Stack per-layer trees into the pipeline's layout.

    Args:
      layer_params: ``{"0": tree, "1": tree, ...}``, one tree of tensors of
        the same structure a layer (a ``SelfAttention``'s parameters by
        name: the encoder's ``self_attends`` children).
      n_stages: pipeline stages; with ``circ_repeats`` they must jointly
        divide the layer count.
      circ_repeats: layer groups a stage for the circular schedule, dealt
        round-robin: virtual stage ``k = g * n_stages + s`` (repeat g,
        stage s) holds layers ``[k * per, (k + 1) * per)``.

    Returns leaves [n_stages, per, ...], or [n_stages, circ_repeats, per,
    ...] where [s, g] is stage s's g-th group (``torch.stack``: the
    gradient reaches each layer's tensors).
    """
    names = sorted(layer_params, key=int)
    n_layers = len(names)
    if circ_repeats < 1:
        raise ValueError(f"circ_repeats must be >= 1; got {circ_repeats}")
    if n_layers % (n_stages * circ_repeats):
        raise ValueError(
            f"{n_layers} layers do not divide into {n_stages} stages"
            + (f" x {circ_repeats} circular repeats" if circ_repeats > 1 else ""))
    per = n_layers // (n_stages * circ_repeats)
    flat = [pytree.tree_flatten(layer_params[n]) for n in names]
    spec = flat[0][1]
    stacked = [torch.stack(leaves) for leaves in zip(*(f[0] for f in flat))]
    if circ_repeats == 1:
        out = [a.reshape(n_stages, per, *a.shape[1:]) for a in stacked]
    else:  # [vstage k, per, ...] -> [g, s, per, ...] -> [s, g, per, ...]
        out = [a.reshape(circ_repeats, n_stages, per, *a.shape[1:]).transpose(0, 1)
               for a in stacked]
    return pytree.tree_unflatten(out, spec)


def unstack_layer_params(stacked, layer_names=None, circ_repeats: int = 1) -> dict:
    """Inverse of ``stack_layer_params``: the per-layer trees (pass the
    ``circ_repeats`` the tree was stacked with: the circular layout's three
    leading dims cannot be told from a layer's own)."""
    if circ_repeats < 1:
        raise ValueError(f"circ_repeats must be >= 1; got {circ_repeats}")
    if circ_repeats > 1:
        return unstack_layer_params_circular(stacked, layer_names)
    lead = pytree.tree_leaves(stacked)[0].shape
    n_layers = lead[0] * lead[1]
    flat = pytree.tree_map(lambda a: a.reshape(n_layers, *a.shape[2:]), stacked)
    return _split_layers(flat, n_layers, layer_names)


def unstack_layer_params_circular(stacked, layer_names=None) -> dict:
    """Inverse of ``stack_layer_params(..., circ_repeats=v)`` for v > 1:
    [n_stages, v, per, ...] -> per-layer trees in layer order."""
    s, v, per = pytree.tree_leaves(stacked)[0].shape[:3]
    n_layers = s * v * per
    flat = pytree.tree_map(
        lambda a: a.transpose(0, 1).reshape(n_layers, *a.shape[3:]), stacked)
    return _split_layers(flat, n_layers, layer_names)


def _split_layers(flat, n_layers, layer_names):
    names = layer_names or [str(i) for i in range(n_layers)]
    return {name: pytree.tree_map(lambda a, i=i: a[i], flat) for i, name in enumerate(names)}


def pp_param_shardings(stacked, mesh, axis_name: str = PIPE_AXIS):
    """A ``NamedSharding`` over ``axis_name`` for every leaf of a
    ``stack_layer_params`` tree: ``.shard(leaf)`` is this rank's stage
    [1, ...], so that each rank holds only its stage's layers, and an
    optimizer made from those pieces only their moments."""
    from perceiverio_pytorch_tpu_torch.parallel.sharding import NamedSharding

    return pytree.tree_map(lambda _: NamedSharding(mesh, (axis_name,)), stacked)


@contextlib.contextmanager
def _without_tensor_parallel(modules):
    """Within the block, the projections and attentions of ``modules`` run
    whole (their ``tp``, set by ``shard_module``, is None): a stage body
    runs whole weights, and no model-axis collective pairs ranks that run
    different layers."""
    saved = [(m, m.__dict__["tp"]) for root in modules for m in root.modules()
             if "tp" in m.__dict__]
    try:
        for m, _ in saved:
            m.tp = None
        yield
    finally:
        for m, tp in saved:
            m.tp = tp


class _Join(torch.autograd.Function):
    """``first``, with ``second`` kept in the graph at a zero gradient."""

    @staticmethod
    def forward(ctx, first, second):
        ctx.like = (second.shape, second.dtype, second.device)
        return first.view_as(first)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        return g, torch.zeros(shape, dtype=dtype, device=device)


class _Schedule(NamedTuple):
    """The index arithmetic of a schedule (JAX ``pipeline.py:301-346``): at
    tick t stage i works on stream item u = t - i, microbatch u % M on
    repeat u // M; items outside [0, v * M) are warm-up or drain bubbles."""

    n_stages: int
    num_microbatches: int
    circ_repeats: int

    @property
    def total(self) -> int:
        return self.circ_repeats * self.num_microbatches

    @property
    def n_ticks(self) -> int:
        return self.total + self.n_stages - 1

    def item(self, t: int, idx: int):
        """(microbatch m, repeat g, valid) of stage ``idx`` at tick ``t``."""
        u = min(max(t - idx, 0), self.total - 1)
        return u % self.num_microbatches, u // self.num_microbatches, 0 <= t - idx < self.total

    def parked(self, t: int) -> Optional[int]:
        """The microbatch slot stage 0 parks what it receives after tick t
        in (it left the last stage with repeats to go), or None."""
        u_prev = t - (self.n_stages - 1)
        if 0 <= u_prev < self.total - self.num_microbatches:
            return u_prev % self.num_microbatches
        return None


class _Stage:
    """One stage's part of a schedule: ``tick`` runs a tick (input, body,
    output write) and ``receive`` takes what the hop delivered after it."""

    def __init__(self, sched: _Schedule, idx: int, xs, body: Callable, seed: Optional[int],
                 remat_policy: Optional[Policy]):
        self.sched, self.idx, self.xs = sched, idx, xs
        self.body, self.seed, self.remat_policy = body, seed, remat_policy
        self.outs: List[Any] = [None] * sched.num_microbatches
        self.parked_items: List[Any] = [None] * sched.num_microbatches

    def tick(self, t: int, state: torch.Tensor) -> torch.Tensor:
        sched, idx = self.sched, self.idx
        m, g, valid = sched.item(t, idx)
        if not valid:
            return state  # a bubble: the hop hands on what arrived
        h = state
        if idx == 0:  # a fresh microbatch on repeat 0, a parked one after
            h = _Join.apply(self.xs[m] if g == 0 else self.parked_items[m], state)
        seed = None if self.seed is None else mix_seed(mix_seed(self.seed, t), idx)
        if self.remat_policy is not None and torch.is_grad_enabled():
            y = remat_call(self.remat_policy, self.body, g, h, seed)
        else:
            y = self.body(g, h, seed)
        if idx == sched.n_stages - 1 and g == sched.circ_repeats - 1:
            self.outs[m] = y
        return y

    def receive(self, t: int, state: torch.Tensor) -> None:
        slot = self.sched.parked(t) if self.idx == 0 else None
        if slot is not None:
            self.parked_items[slot] = state

    def outputs(self, last: torch.Tensor) -> torch.Tensor:
        """[M, rows, ...]: the last stage's outputs; zeros on the others,
        joined to their ``last`` tick's output, through which the loss
        reaches their hops' backward."""
        if self.idx != self.sched.n_stages - 1:
            return _Join.apply(torch.zeros_like(self.xs), last)
        return torch.stack(self.outs)


def _check_schedule(b: int, num_microbatches: int, n_stages: int, circ_repeats: int):
    if b % num_microbatches:
        raise ValueError(f"batch {b} does not divide into {num_microbatches} microbatches")
    if circ_repeats < 1:
        raise ValueError(f"circ_repeats must be >= 1; got {circ_repeats}")
    if circ_repeats > 1 and num_microbatches < n_stages:
        raise ValueError(
            f"the circular schedule needs num_microbatches ({num_microbatches}) >= n_stages"
            f" ({n_stages}): a microbatch re-enters stage 0 exactly num_microbatches ticks"
            " after leaving it")


def _row_axis(mesh, batch_axis: Optional[str], rows: int):
    """The data axis a microbatch's rows split over (JAX: ``batch_axis``
    when the mesh has it and it divides them), or None: the rows are
    replicated, or the caller split the batch over it already."""
    caller = cc.data_group()
    if caller is not None:
        names = getattr(mesh, "mesh_dim_names", ())
        mine = (dist.get_process_group_ranks(axis(mesh, batch_axis).group)
                if batch_axis in names else [dist.get_rank()])
        if dist.get_process_group_ranks(caller) != mine:
            raise ValueError(
                "the batch is split over a data axis other than the pipeline mesh's: the"
                " ranks of a pipe group must hold the same rows (make the pipeline mesh's"
                " data axis the trainer's)")
        return None
    if batch_axis is None or batch_axis not in getattr(mesh, "mesh_dim_names", ()):
        return None
    ax = axis(mesh, batch_axis)
    return ax if ax.size > 1 and rows % ax.size == 0 else None


def _run(body: Callable, params, x: torch.Tensor, mesh, *, num_microbatches: int,
         axis_name: str, batch_axis: Optional[str], num_blocks: int, seed: Optional[int],
         circ_repeats: int, params_over_pipe: bool, remat_policy: Optional[Policy] = None):
    """The schedule.  ``mesh``: a mesh, whose ``axis_name`` stage this rank
    runs, each tick's output handed on by ``ring_hop``; or an int S, the S
    stages run in this process, each tick's outputs handed on by a list
    rotation (the schedule held where one device cannot hold a pipe axis).
    ``body(params, idx, g, h, seed)`` runs stage idx's group g on h,
    ``params`` the entry node's outputs of ``params`` (replicated over the
    pipe axis with ``params_over_pipe``, else this stage's own)."""
    local = isinstance(mesh, int)
    pipe = None if local else axis(mesh, axis_name)
    n_stages = mesh if local else pipe.size
    b = x.shape[0]
    _check_schedule(b, num_microbatches, n_stages, circ_repeats)
    sched = _Schedule(n_stages, num_microbatches, circ_repeats)
    mb = b // num_microbatches
    data = None if local else _row_axis(mesh, batch_axis, mb)
    split = [data.group] if data is not None else []
    if not local:
        groups = [[pipe.group] + split] + [([pipe.group] if params_over_pipe else []) + split
                                           for _ in params]
    out = x
    for blk in range(num_blocks):
        if local:
            xin, entered = out, list(params)
        else:
            xin, *entered = cc.copy_to_many([out] + list(params), groups)
        xs = xin.reshape(num_microbatches, mb, *x.shape[1:])
        if data is not None:
            xs = cc.local_piece(xs, 1, data.group)
        stages = [_Stage(sched, idx, xs, functools.partial(body, entered, idx),
                         None if seed is None else mix_seed(seed, blk), remat_policy)
                  for idx in (range(n_stages) if local else [pipe.index])]
        states = [_Join.apply(torch.zeros_like(xs[0]), xs)] * len(stages)
        for t in range(sched.n_ticks):
            ys = [stage.tick(t, state) for stage, state in zip(stages, states)]
            if t + 1 < sched.n_ticks:
                states = ys[-1:] + ys[:-1] if local else [cc.ring_hop(ys[0], pipe.group)]
                for stage, state in zip(stages, states):
                    stage.receive(t, state)
        outs = stages[-1].outputs(ys[-1])
        if not local:
            outs = cc.reduce_from(outs, pipe.group)
        if data is not None:
            outs = cc.gather_dim(outs, 1, data.group)
        out = outs.reshape(b, *x.shape[1:])
    return out


def _group(leaves, spec, row: int, g: int, circ_repeats: int):
    """Group g of stage ``row``'s params, of ``leaves`` [S or 1, (v,) per,
    ...]: a tree of [per, ...] leaves."""
    mine = [a[row] for a in leaves]
    return pytree.tree_unflatten([a[g] for a in mine] if circ_repeats > 1 else mine, spec)


def pipeline_spmd(stage_fn: Callable, stage_params, x: torch.Tensor, mesh, *,
                  num_microbatches: int, axis_name: str = PIPE_AXIS,
                  batch_axis: Optional[str] = DATA_AXIS, num_blocks: int = 1,
                  rng: Optional[int] = None, circ_repeats: int = 1) -> torch.Tensor:
    """Run ``x`` through a depth-sharded stack with the GPipe schedule (the
    circular one with ``circ_repeats`` > 1).

    Args:
      stage_fn: ``(local_params, x_mb) -> y_mb`` (with ``rng``: ``(...,
        seed)``), applied by each rank to its stage's layer group; it keeps
        x's shape and dtype.
      stage_params: a tree whose leaves are [n_stages, per, ...] (or [S, v,
        per, ...]) on every rank, replicated, or this rank's [1, ...] slice
        (``pp_param_shardings``); see the module docstring for their
        gradients.
      x: [B, ...], B a multiple of ``num_microbatches``.
      mesh: a mesh with ``axis_name`` (and ``batch_axis``, whose ranks take
        the rows of each microbatch it divides); or an int S: S virtual
        stages in this process, each stage's output handed to the next in
        place of the ring's send (leaves [S, ...], rows not split).
      num_blocks: weight-shared passes of the whole stack.
      rng: a seed for stochastic stage bodies (dropout): see the module
        docstring.
      circ_repeats: > 1 runs the circular schedule (num_microbatches >=
        n_stages), whose bubble is (S-1)/(v*M+S-1) of the ticks against
        GPipe's (S-1)/(M+S-1).

    Returns [B, ...] on every rank, the microbatches in order.
    """
    n_stages = mesh if isinstance(mesh, int) else axis(mesh, axis_name).size
    flat, spec = pytree.tree_flatten(stage_params)
    whole = flat[0].shape[0] == n_stages and n_stages > 1

    def body(leaves, idx, g, h, seed):
        p = _group(leaves, spec, idx if whole else 0, g, circ_repeats)
        return stage_fn(p, h) if rng is None else stage_fn(p, h, seed)

    return _run(body, flat, x, mesh, num_microbatches=num_microbatches, axis_name=axis_name,
                batch_axis=batch_axis, num_blocks=num_blocks, seed=rng,
                circ_repeats=circ_repeats, params_over_pipe=whole)


def pipelined_self_attends(layer, layer_params: dict, latents: torch.Tensor, mesh, *,
                           num_microbatches: int, axis_name: str = PIPE_AXIS,
                           batch_axis: Optional[str] = DATA_AXIS, num_blocks: int = 1,
                           stacked: bool = False, dropout_rng: Optional[int] = None,
                           circ_repeats: int = 1) -> torch.Tensor:
    """Apply a distinct-layer self-attend stack as a pipeline.

    Args:
      layer: a ``core.attention.SelfAttention`` configured as the stack's
        layers; each layer's tensors run through it
        (``torch.func.functional_call``), in its own mode (``train()`` with
        a dropout rate needs ``dropout_rng``).
      layer_params: ``{"0": {name: tensor}, ...}`` (the stack's
        ``state_dict`` children), or with ``stacked`` a
        ``stack_layer_params`` tree.
      latents: [B, N, D].
      dropout_rng: an int seed for the layers' dropout (see the module
        docstring).
      circ_repeats: > 1 runs the circular schedule.

    Returns [B, N, D], the sequential stack's (dropout aside: the masks
    follow the schedule's seeds).
    """
    if stacked and circ_repeats > 1:
        # a [S, per, ...] tree fed to the circular schedule would silently
        # index layers as groups; the circular layout is [S, v, per, ...]
        lead = pytree.tree_leaves(layer_params)[0].shape
        if len(lead) < 3 or lead[1] != circ_repeats:
            raise ValueError(
                f"stacked=True with circ_repeats={circ_repeats} expects the"
                f" [n_stages, {circ_repeats}, per, ...] layout from"
                f" stack_layer_params(..., circ_repeats={circ_repeats});"
                f" got leading dims {tuple(lead[:3])}")
    stage_params = layer_params if stacked else stack_layer_params(
        layer_params, axis(mesh, axis_name).size, circ_repeats=circ_repeats)
    return pipeline_spmd(layer_stage_fn(layer), stage_params, latents, mesh,
                         num_microbatches=num_microbatches, axis_name=axis_name,
                         batch_axis=batch_axis, num_blocks=num_blocks, rng=dropout_rng,
                         circ_repeats=circ_repeats)


def _apply_layers(pairs, h: torch.Tensor, seed: Optional[int]) -> torch.Tensor:
    """A stage body: each (module, params) of ``pairs`` applied in turn to h
    with whole weights (``torch.func.functional_call``; no model-axis
    collective inside a tick), the j-th with the dropout seed ``mix_seed(seed,
    j)`` (JAX ``_stage_scan_fn``)."""
    with _without_tensor_parallel([module for module, _ in pairs]):
        for j, (module, params) in enumerate(pairs):
            h = torch.func.functional_call(
                module, params, (h,), {"dropout_seed": None if seed is None else mix_seed(seed, j)})
    return h


def layer_stage_fn(layer) -> Callable:
    """The stage body ``pipelined_self_attends`` runs: ``(local_params, h[,
    seed]) -> h``, ``layer`` applied to each layer of ``local_params`` (a
    name -> [per, ...] tensor mapping of parameters, and any buffers) in
    turn."""

    def stage_fn(local_params, h, seed=None):
        per = pytree.tree_leaves(local_params)[0].shape[0]
        return _apply_layers([(layer, pytree.tree_map(lambda a, j=j: a[j], local_params))
                              for j in range(per)], h, seed)

    return stage_fn


def _whole_weights(layers) -> List[torch.Tensor]:
    """Every parameter of ``layers`` in ``named_parameters`` order, whole:
    the model-axis pieces of a tensor-parallel projection all-gathered
    (``gather_dim``: the gradient's own piece comes back)."""
    from perceiverio_pytorch_tpu_torch.core.attention import Dense

    out = []
    for layer in layers:
        for name, p in layer.named_parameters():
            owner, _, leaf = name.rpartition(".")
            mod = layer.get_submodule(owner)
            mode, ax = (mod.tp if isinstance(mod, Dense) and mod.tp is not None
                        else (None, None))
            dim = 0 if mode == "col" else (1 if mode == "row" and leaf == "weight" else None)
            out.append(p if dim is None else cc.gather_dim(p, dim, ax.group))
    return out


def pipeline_layers(layers, latents: torch.Tensor, policy: Policy, *,
                    dropout_seed: Optional[int] = None, remat: bool = False,
                    stages: Optional[int] = None) -> torch.Tensor:
    """``Policy.pp_mesh``'s route: the stack's own ``layers`` (each rank
    holds them all, as JAX's ``_pipelined`` stacks the module's variables at
    apply time) as a pipeline over ``policy.pp_axis``, one block.  A stage
    runs its layers' own modules with whole weights (tensor-parallel pieces
    gathered at the entry); every layer's gradient is summed over the pipe
    (and split data) axes, so that each rank holds it whole.  ``remat``:
    each stage body a checkpointed region under ``policy.remat_policy``.
    ``stages``: run that many stages in this process instead (``_run``'s
    local hop; ``policy.pp_mesh`` unused)."""
    layers = list(layers)
    mesh = policy.pp_mesh if stages is None else stages
    n_stages = stages or axis(mesh, policy.pp_axis).size
    v = policy.pp_circ_repeats
    if len(layers) % (n_stages * v):
        raise ValueError(
            f"{len(layers)} self-attend layers do not divide into {n_stages} pipeline"
            " stages" + (f" x {v} circular repeats" if v > 1 else ""))
    per = len(layers) // (n_stages * v)
    names = [[n for n, _ in layer.named_parameters()] for layer in layers]
    offsets = [0]
    for n in names:
        offsets.append(offsets[-1] + len(n))

    def body(entered, idx, g, h, seed):
        first = (g * n_stages + idx) * per  # virtual stage k = g * S + idx
        return _apply_layers(
            [(layers[i], dict(zip(names[i], entered[offsets[i]:offsets[i + 1]])))
             for i in range(first, first + per)], h, seed)

    return _run(body, _whole_weights(layers), latents, mesh,
                num_microbatches=policy.pp_microbatches, axis_name=policy.pp_axis,
                batch_axis=DATA_AXIS, num_blocks=1, seed=dropout_seed, circ_repeats=v,
                params_over_pipe=True, remat_policy=policy if remat else None)
