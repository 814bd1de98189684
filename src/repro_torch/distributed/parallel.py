"""The port's counterpart of what GSPMD does for the reference: explicit
shards, explicit process groups, and collectives where the shards meet.

* ``MeshContext`` -- a ``DeviceMesh`` as the model code sees it: this
  rank's coordinate on each axis, each axis's process group
  (``DeviceMesh.get_group``), the joint groups of the rules' axis tuples
  (``("pod", "data")``), the device and the sharding rules.  A step makes
  its context current (``use_mesh``) while it runs; with none current,
  every hook below is the identity and the model runs as on one device.
* ``shard_tree`` / ``gather_tree`` (``shard_leaf`` / ``gather_leaf``
  for one leaf) -- cut a full tree to this rank's shards by a
  PartitionSpec tree, and put the shards back together.
* The serve steps' cache plan (``MeshContext.for_serving``): the rows of
  the batch the step's batch spec cuts (all of them where a batch of one
  replicates), and the mesh axis each ring's sequence axis is cut over
  (``ring_shard``: this rank's slot range of a ring and its group).
* The autograd collectives of Megatron-style TP and of FSDP:
  ``reduce_from`` (forward all-reduce, backward identity: the end of a
  region whose ranks hold partial sums), ``copy_to`` (forward identity,
  backward all-reduce: a replicated tensor entering such a region),
  ``gather_from`` (forward all-gather, backward reduce-scatter: FSDP's
  weight gather, whose gradient is summed over the ranks' local losses;
  the train step normalises each rank's loss by the global token count,
  so the sum is the global batch's mean) and ``gather_keep`` (forward
  all-gather, backward this rank's slice: logits gathered over the
  vocabulary for a loss every model rank computes alike).
* Megatron-style sequence parallelism over ``model`` (the reference's
  ``_constrain_act``): ``MeshContext.seq_parallel`` decides, once for a
  stack, by the reference's rule, whether its residual stream is cut
  along S; ``split_to`` (forward this rank's rows, backward all-gather)
  enters it, ``gather_from`` along S opens a block's model-cut region,
  ``scatter_from`` (forward reduce-scatter, backward all-gather) closes
  it, and ``gather_keep`` along S leaves it.  The model code goes
  through ``seq_gather``, ``enter``, ``leave`` and ``seq_weight``, which
  are TP's ``copy_to`` / ``reduce_from`` (or nothing) where the stack's
  S is whole.

Every collective of a group of one rank is skipped, so a world of one
runs the single-device step's operations exactly.  A collective that
fails raises; nothing falls back.  ``record_collectives`` lists, in
order, the collectives the helpers make inside a block (kind, result
bytes, group size): the dry run's step pass reads a step's traffic from
it, and real ranks can hold their traffic to that pass's.

``gloo`` with CUDA tensors (two ranks sharing one card, where NCCL
refuses): every collective used here (``all_reduce`` with SUM and MAX,
``all_gather`` of int8 and f32, ``reduce_scatter``, ``new_group``) takes
CUDA tensors in torch 2.11+cu128 on an H100, so nothing is staged
through host memory.  The names used exist in torch 2.11 and 2.13
(``reduce_scatter`` of a list, not ``reduce_scatter_tensor``).
"""
from __future__ import annotations

import contextlib
import copy
import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

# the contexts of the steps running now, innermost last: a process-wide
# stack, not a context variable, because the autograd engine runs a
# CUDA backward (and remat's recompute inside it) on its own threads
_ACTIVE: list = []


def current() -> Optional["MeshContext"]:
    """The mesh context of the step running now, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def use_mesh(ctx: Optional["MeshContext"]):
    """Make ``ctx`` current for the model code run inside (None: no
    mesh, the single-device path)."""
    _ACTIVE.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.pop()


# ---------------------------------------------------------------------------
# Plain collectives (no autograd)
# ---------------------------------------------------------------------------


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


# the lists of the ``record_collectives`` blocks open now (process-wide,
# as ``_ACTIVE``: a CUDA backward runs on the autograd engine's threads)
_RECORDERS: list = []


@contextlib.contextmanager
def record_collectives():
    """Within the block, every collective this process's helpers below
    make, in order, as ``(kind, bytes, group size)``: the kind as XLA
    names it (``"all-reduce"``, ``"all-gather"``, ``"reduce-scatter"``)
    and the bytes of its result on this rank (the reduced tensor, the
    gathered whole, this rank's chunk).  A group of one rank makes no
    collective and records none.  Works on any backend: the dry run's
    fake world, gloo and NCCL ranks alike."""
    calls: list = []
    _RECORDERS.append(calls)
    try:
        yield calls
    finally:
        _RECORDERS.remove(calls)


def _record(kind: str, result: torch.Tensor, n: int) -> None:
    for calls in _RECORDERS:
        calls.append((kind, result.numel() * result.element_size(), n))


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``t`` reduced over ``group`` (``"sum"`` or
    ``"max"``)."""
    n = group_size(group)
    if n == 1:
        return t
    out = t.clone()
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=group)
    _record("all-reduce", out, n)
    return out


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` in group-rank order."""
    n = group_size(group)
    if n == 1:
        return t[None]
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    out = torch.stack(parts)
    _record("all-gather", out, n)
    return out


def gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order."""
    if group_size(group) == 1:
        return t
    return torch.cat(list(all_gather(t, group).unbind(0)), dim=dim)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group``, this rank's equal
    chunk along ``dim``."""
    n = group_size(group)
    if n == 1:
        return t
    chunks = [c.contiguous() for c in t.chunk(n, dim=dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    _record("reduce-scatter", out, n)
    return out


# ---------------------------------------------------------------------------
# Autograd collectives
# ---------------------------------------------------------------------------


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _GatherKeep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.start = dist.get_rank(group) * ctx.n
        return gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n), None, None


class _ScatterFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return gather_cat(g, ctx.dim, ctx.group), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = x.shape[dim] // group_size(group)
        # a copy: the rows must not keep the whole tensor's storage alive
        return x.narrow(dim, dist.get_rank(group) * n, n).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return gather_cat(g, ctx.dim, ctx.group), None, None


class _OwnRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // group_size(ctx.group)
        out = torch.zeros_like(g)
        start = dist.get_rank(ctx.group) * n
        out.narrow(ctx.dim, start, n).copy_(g.narrow(ctx.dim, start, n))
        return out, None, None


def _unflat(fn, x: torch.Tensor, lead):
    """``fn`` on x (T, d) viewed as (*lead, d), flattened back to rows."""
    if lead is None:
        return fn(x)
    return fn(x.view(*lead, x.shape[-1])).flatten(0, -2)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Forward all-reduce (sum), backward identity."""
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Forward identity, backward all-reduce (sum)."""
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Forward all-gather along ``dim``, backward reduce-scatter (sum)."""
    return x if group_size(group) == 1 else _GatherFrom.apply(x, dim, group)


def gather_keep(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Forward all-gather along ``dim``, backward this rank's slice."""
    return x if group_size(group) == 1 else _GatherKeep.apply(x, dim, group)


def scatter_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Forward reduce-scatter along ``dim`` (the sum of the ranks' partial
    sums, this rank's equal chunk), backward all-gather."""
    return x if group_size(group) == 1 else _ScatterFrom.apply(x, dim, group)


def split_to(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Forward this rank's equal chunk along ``dim`` of a tensor every rank
    holds whole (a copy), backward all-gather."""
    return x if group_size(group) == 1 else _SplitTo.apply(x, dim, group)


def own_rows(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Forward the identity, backward this rank's chunk along ``dim`` of
    the gradient and zeros elsewhere: a gradient every rank holds whole
    becomes this rank's share of a sum over ``group``."""
    return x if group_size(group) == 1 else _OwnRows.apply(x, dim, group)


# ---------------------------------------------------------------------------
# Sequence parallelism: the hooks the model code calls
# ---------------------------------------------------------------------------


def _seq_ctx() -> Optional["MeshContext"]:
    ctx = current()
    return ctx if ctx is not None and ctx.seq else None


def seq_gather(x: torch.Tensor) -> torch.Tensor:
    """A block's input to its model-cut regions, from the residual stream
    (its normed rows): with the stack's S cut over ``model`` the rows are
    gathered along S (backward: the reduce-scatter of the regions'
    partial gradients, ``gather_from``); else ``x`` itself."""
    ctx = _seq_ctx()
    return x if ctx is None else gather_from(x, 1, ctx.model)


def enter(x: torch.Tensor, group, dim: int = 1, lead=None) -> torch.Tensor:
    """A region's input (from ``seq_gather``) as the weights read it.
    ``group``: the model group where the model axis cuts the weights,
    None where they are whole.  S whole: TP's ``copy_to`` where cut, else
    ``x``.  S cut: ``x`` where cut (its gradient is a partial sum, which
    the gather's reduce-scatter sums); where whole, ``own_rows``, so the
    whole gradient every rank computes alike enters that sum once.  S is
    ``x``'s dim ``dim``, or with ``lead`` x is (T, d) tokens flattened
    from (*lead, d) and S is ``lead``'s dim ``dim``."""
    ctx = _seq_ctx()
    if ctx is None:
        return x if group is None else copy_to(x, group)
    if group is not None:
        return x
    return _unflat(lambda t: own_rows(t, dim, ctx.model), x, lead)


def leave(y: torch.Tensor, group, dim: int = 1, lead=None) -> torch.Tensor:
    """A region's output back into the residual stream.  ``group`` as in
    ``enter``: the ranks hold partial sums where it is given, the whole
    output alike where it is None.  S whole: TP's ``reduce_from``, or
    ``y``.  S cut: the reduce-scatter along S (``scatter_from``), or this
    rank's rows (``split_to``); ``dim`` and ``lead`` as in ``enter``."""
    ctx = _seq_ctx()
    if ctx is None:
        return y if group is None else reduce_from(y, group)
    if group is not None:
        return _unflat(lambda t: scatter_from(t, dim, ctx.model), y, lead)
    return _unflat(lambda t: split_to(t, dim, ctx.model), y, lead)


def seq_weight(w: torch.Tensor) -> torch.Tensor:
    """A replicated weight applied to the residual stream's rows (a norm's
    scale): with S cut each rank's gradient covers its rows only, so it
    is summed over ``model`` (``copy_to``); else ``w``."""
    ctx = _seq_ctx()
    return w if ctx is None else copy_to(w, ctx.model)


# ---------------------------------------------------------------------------
# The mesh as the model sees it
# ---------------------------------------------------------------------------


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one PartitionSpec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class MeshContext:
    """A ``DeviceMesh`` with the sharding rules: sizes, this rank's
    coordinates, and a process group for every axis and for every axis
    tuple the rules name (built here, on every rank in one order)."""

    def __init__(self, mesh, rules=None):
        from repro_torch.distributed import sharding as shd

        self.mesh = mesh
        self.rules = rules or shd.DEFAULT_RULES
        self.sizes = shd.mesh_axis_sizes(mesh)
        self.names = tuple(self.sizes)
        self.coords = dict(zip(self.names, mesh.get_coordinate()))
        self.groups = {a: mesh.get_group(a) for a in self.names}
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda"
                       else torch.device(mesh.device_type))
        self.row_axes = self.batch_axes
        # the global rows of the batch a train step's model call runs
        # (``with_rows``), which need not divide over the row axes
        self.n_rows: Optional[int] = None
        self.ring_seq: Optional[Callable[[int], object]] = None
        self.cross_seq = None
        # set by the train and prefill steps from ``cfg.act_sharding``
        self.act_sharding = False
        # a stack's context whose residual stream is cut along S
        self.seq = False
        ranks = mesh.mesh
        tuples = {tuple(a for a in cand if a in self.sizes)
                  for _, cands in self.rules.rules for cand in cands
                  if isinstance(cand, tuple)}
        tuples.add(tuple(a for a in self.rules.batch_axes if a in self.sizes))
        self._joint = {}
        for axes in sorted(t for t in tuples if len(t) > 1):
            dims = [self.names.index(a) for a in axes]
            rest = [i for i in range(len(self.names)) if i not in dims]
            rows = ranks.permute(*rest, *dims).reshape(
                -1, math.prod(self.sizes[a] for a in axes))
            for row in rows.tolist():
                g = dist.new_group(row)
                if dist.get_rank() in row:
                    self._joint[axes] = g

    def size(self, entry) -> int:
        return math.prod(self.sizes.get(a, 1) for a in entry_axes(entry))

    def coord(self, entry) -> int:
        """This rank's index along an entry's axes (row-major)."""
        idx = 0
        for a in entry_axes(entry):
            idx = idx * self.sizes.get(a, 1) + self.coords.get(a, 0)
        return idx

    def group(self, entry):
        """The process group spanning an entry's axes (None: one rank)."""
        axes = tuple(a for a in entry_axes(entry)
                     if self.sizes.get(a, 1) > 1)
        if not axes:
            return None
        if len(axes) == 1:
            return self.groups[axes[0]]
        full = tuple(a for a in entry_axes(entry) if a in self.sizes)
        return self._joint[full]

    # -- the axes the model code asks for --------------------------------

    @property
    def model(self):
        return self.group("model")

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.rules.batch_axes if a in self.sizes)

    @property
    def batch(self):
        """The group over every batch axis (pod x data)."""
        return self.group(self.batch_axes)

    @property
    def batch_world(self) -> int:
        return self.size(self.batch_axes)

    @property
    def batch_rank(self) -> int:
        return self.coord(self.batch_axes)

    # -- the rows a step's batch spec cuts ---------------------------------

    @property
    def rows(self):
        """The group over the axes that cut the batch's rows: the batch
        axes, or those of a serve step's batch spec (``for_serving``),
        fewer where the batch does not split over all of them."""
        return self.group(self.row_axes)

    @property
    def row_world(self) -> int:
        return self.size(self.row_axes)

    def global_rows(self, b: int) -> int:
        """The rows of the global batch of which this rank holds ``b``:
        the count a train step set (``with_rows``; ranks may hold
        different counts, some none), else ``b`` on each of the
        ``row_world`` ranks."""
        return self.n_rows if self.n_rows is not None else b * self.row_world

    def with_rows(self, n: int) -> "MeshContext":
        """A copy for one model call over a global batch of ``n`` rows,
        cut over the row axes in GSPMD's padded shards
        (``launch.train._local_rows``).  The copy shares the process
        groups."""
        ctx = copy.copy(self)
        ctx.n_rows = n
        return ctx

    # -- sequence parallelism ---------------------------------------------

    def seq_parallel(self, s: int) -> Optional["MeshContext"]:
        """The context of a stack whose residual stream has ``s`` positions,
        where the reference's ``_constrain_act`` cuts it: with
        ``act_sharding`` on, a model axis larger than one, ``s > 1`` and
        ``s`` a multiple of it, a copy whose blocks hold their rows of S
        between blocks (``seq``); else None, and the stack keeps S
        whole.  The copy shares the process groups."""
        m = self.size("model")
        if not self.act_sharding or m == 1 or s == 1 or s % m:
            return None
        ctx = copy.copy(self)
        ctx.seq = True
        return ctx

    # -- a serve step's cache ---------------------------------------------

    def for_serving(self, row_axes: tuple[str, ...],
                    ring_seq: Callable[[int], object],
                    cross_seq=None) -> "MeshContext":
        """A copy for one serve step: its batch spec's axes ``row_axes``,
        ``ring_seq(slots)``, the mesh axis (a spec entry, or None) that
        the step's cache spec cuts the sequence axis of a ring of
        ``slots`` slots over, and ``cross_seq``, the entry it cuts the
        cross attention K/V's encoder axis over.  The copy shares the
        process groups."""
        ctx = copy.copy(self)
        ctx.row_axes = tuple(row_axes)
        ctx.ring_seq = ring_seq
        ctx.cross_seq = cross_seq
        return ctx

    # -- FSDP -------------------------------------------------------------

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.sizes)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.names

    def fsdp_leaf(self, t: torch.Tensor, p) -> torch.Tensor:
        """``t``, a leaf of def ``p`` (``models.params.P``; a stacked leaf
        or one layer of it), whole along every dim the rules cut over the
        batch axes."""
        from repro_torch.distributed.sharding import spec_for

        spec = spec_for(p.axes, p.shape, self, self.rules)
        for dim, entry in enumerate(spec):
            axes = entry_axes(entry)
            if axes and set(axes) <= set(self.batch_axes):
                g = self.group(entry)
                if g is not None:
                    t = gather_from(t, t.ndim - len(spec) + dim, g)
        return t

    def fsdp_gather(self, tree, defs):
        """A layer's leaves gathered over the batch axes where the rules
        cut them (FSDP), ``defs`` its def tree."""
        from repro_torch.models import params as prm

        return prm.tree_map(lambda t, p: self.fsdp_leaf(t, p), tree, defs)

    @property
    def fsdp(self) -> bool:
        return self.batch_world > 1


class RingShard(NamedTuple):
    """This rank's share of a ring whose sequence axis the step's cache
    spec cuts: slots [lo, lo + local) of the ring's ``total``, held by
    rank ``rank`` of the ``n`` ranks of ``group`` (over mesh axis
    ``entry``)."""

    group: object
    n: int
    rank: int
    lo: int
    local: int
    total: int
    entry: object


def ring_shard(k: torch.Tensor, kpos: torch.Tensor) -> Optional[RingShard]:
    """The current step's cut of a ring (k ``(..., B, local, Hkv, dh)``,
    kpos ``(..., B, total)``, which the cache specs never cut along the
    sequence), or None where the ring is whole.  Raises where the ring
    does not match the step's spec: a cut ring with no mesh, or a whole
    ring where the spec cuts it (a long-context decode step takes its
    cache from a prefill only through ``launch.serve.cut_cache``)."""
    ctx = current()
    local, total = k.shape[-3], kpos.shape[-1]
    ring_seq = None if ctx is None else ctx.ring_seq
    entry = None if ring_seq is None else ring_seq(total)
    n = 1 if entry is None else ctx.size(entry)
    if local * n != total:
        raise ValueError(
            f"a ring of {local} of {total} slots does not match the "
            f"step's cache spec, which cuts it over "
            f"{entry!r} ({n} ranks)")
    if n == 1:
        return None
    r = ctx.coord(entry)
    return RingShard(ctx.group(entry), n, r, r * local, local, total, entry)


def cross_shard(k: torch.Tensor) -> Optional[RingShard]:
    """The current step's cut of a cross attention K/V along its encoder
    axis (k ``(B, local, Hkv, dh)``, the rank's ``local`` positions of
    ``local * n``), or None where the step's cache spec keeps it whole."""
    ctx = current()
    entry = None if ctx is None else ctx.cross_seq
    n = 1 if entry is None else ctx.size(entry)
    if n == 1:
        return None
    local, r = k.shape[-3], ctx.coord(entry)
    return RingShard(ctx.group(entry), n, r, r * local, local, local * n,
                     entry)


def context(mesh, rules=None, act_sharding: bool = False
            ) -> Optional[MeshContext]:
    """The context of a ``DeviceMesh``; None for no mesh, or a shape-only
    mesh of one device (the single-device path).  ``act_sharding``: a
    train or prefill step's ``cfg.act_sharding``, under which a stack's
    residual stream is cut along S where the reference cuts it
    (``MeshContext.seq_parallel``).  A shape-only mesh of more devices,
    or a DeviceMesh with no initialised process group, raises."""
    if mesh is None or isinstance(mesh, MeshContext):
        if mesh is not None and mesh.act_sharding != act_sharding:
            mesh = copy.copy(mesh)
            mesh.act_sharding = act_sharding
        return mesh
    if not hasattr(mesh, "get_group"):
        from repro_torch.distributed.sharding import mesh_axis_sizes

        n = math.prod(mesh_axis_sizes(mesh).values())
        if n == 1:
            return None
        raise RuntimeError(f"a mesh of {n} devices needs a DeviceMesh "
                           f"(launch.mesh.make_mesh) over an initialised "
                           f"process group, not {type(mesh).__name__}")
    if mesh.device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; a CPU mesh "
                           "(device_type='cpu') runs the port's plain "
                           "PyTorch paths")
    if not dist.is_initialized():
        raise RuntimeError("a sharded step needs an initialised process "
                           "group")
    ctx = MeshContext(mesh, rules)
    ctx.act_sharding = act_sharding
    return ctx


def check_device(device, mesh_device: torch.device) -> None:
    """Raise when a step on a mesh of ``mesh_device`` is asked for another
    device (``None`` asks for none)."""
    if device is None:
        return
    d = torch.device(device)
    if d.type != mesh_device.type or (d.index is not None
                                      and d.index != mesh_device.index):
        raise ValueError(f"device {d} on a mesh of {mesh_device}")


# ---------------------------------------------------------------------------
# Whole trees
# ---------------------------------------------------------------------------


def shard_leaf(t: torch.Tensor, spec, ctx: MeshContext) -> torch.Tensor:
    """This rank's block of one whole leaf by its spec (a view).  A dim
    that does not divide over its entry's axes raises ``ValueError``, as
    the reference's ``device_put`` onto such a ``NamedSharding`` does."""
    for dim, entry in enumerate(spec):
        n = ctx.size(entry)
        if n > 1:
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                                 f"divide over {entry!r} ({n} ranks)")
            size = t.shape[dim] // n
            t = t.narrow(dim, ctx.coord(entry) * size, size)
    return t


def gather_leaf(t: torch.Tensor, spec, ctx: MeshContext) -> torch.Tensor:
    """One leaf whole again from this rank's shard: an all-gather over
    each dim its spec cuts (collective: every rank of the mesh calls it)."""
    for dim, entry in enumerate(spec):
        t = gather_cat(t, dim, ctx.group(entry))
    return t


def shard_tree(tree, specs, mesh_or_ctx):
    """This rank's shard of every leaf of a full tree (params, a cache),
    by a matching PartitionSpec tree, as contiguous copies."""
    from repro_torch.distributed.sharding import is_spec
    from repro_torch.models import params as prm

    ctx = _as_ctx(mesh_or_ctx)
    leaves, treedef = prm.flatten(tree)
    spec_leaves = prm.flatten(specs, is_leaf=is_spec)[0]
    if ctx is None:
        return prm.unflatten(treedef, [t.clone() for t in leaves])
    return prm.unflatten(treedef, [shard_leaf(t, s, ctx).contiguous().clone()
                                   for t, s in zip(leaves, spec_leaves)])


def gather_tree(tree, specs, mesh_or_ctx):
    """Every leaf whole again (``gather_leaf``): the inverse of
    ``shard_tree``, for checks.  Every rank then holds the whole tree on
    its device; a checkpoint's save gathers one leaf at a time instead
    (``checkpoint.manager``)."""
    from repro_torch.distributed.sharding import is_spec
    from repro_torch.models import params as prm

    ctx = _as_ctx(mesh_or_ctx)
    leaves, treedef = prm.flatten(tree)
    if ctx is None:
        return tree
    spec_leaves = prm.flatten(specs, is_leaf=is_spec)[0]
    return prm.unflatten(treedef, [gather_leaf(t, spec, ctx)
                                   for t, spec in zip(leaves, spec_leaves)])


def _as_ctx(mesh_or_ctx):
    if mesh_or_ctx is None or isinstance(mesh_or_ctx, MeshContext):
        return mesh_or_ctx
    return context(mesh_or_ctx)
