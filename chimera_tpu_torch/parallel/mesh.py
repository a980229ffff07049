"""Distribution layer on ``torch.distributed``: the process grid, padding,
sharding, and the batched evaluation over ranks (counterpart of
``chimera_tpu/parallel/mesh.py``).

The JAX package places event and injection leaves with NamedShardings and
lets ``shard_map`` insert the psums.  Here every rank is a process of its
own, holds only its shard, and the reductions are explicit collectives:

* 'data' (shard events + injections, all-reduce): the per-λ sums of log
  numerators and the selection's two sums are all-reduced (SUM) over the
  ranks that share a λ slice (``log_like_batch_sharded``);
* 'params' (split the λ batch): each rank evaluates its slice of the batch,
  and the (L,) result is all-reduced over the ranks that hold the same
  events, each writing only its slice;
* 'both': the two axes of one (params x data) grid, data the inner axis.

A rank's shard holds its events and injections only, so each rank's memory
falls by the data size.  Collectives carry no gradient here: the sharded
batch refuses a tensor that requires grad (ROADMAP.md §1 item 18).
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist
from torch import nn

from chimera_tpu_torch.config import resolve_device
from chimera_tpu_torch.likelihood import HyperLikelihood
from chimera_tpu_torch.selection import SelectionFunction

DATA_AXIS = "data"
PARAMS_AXIS = "params"


def init_distributed(require: bool = False, backend: str | None = None,
                     init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None, timeout=None) -> None:
    """Join the process group of a multi-process run (the port's
    counterpart of the reference's ``mpirun`` bring-up).

    The group comes from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) or from ``init_method``
    (e.g. ``file://...`` or ``tcp://localhost:PORT``) with ``rank`` and
    ``world_size``.  With neither, one process runs alone and this is a
    no-op, unless ``require=True``, which raises.  Already joined: no-op.

    A group is joined only with its ``backend`` named: 'nccl' where each
    rank owns a card (the card of its ``LOCAL_RANK``, made current here);
    'gloo' for CPU ranks, and for several ranks sharing one card (NCCL
    refuses two ranks on one card; gloo all-reduces CUDA tensors).  A
    backend that fails raises; none is tried in its place.  ``timeout``
    (seconds or a timedelta) bounds the rendezvous and every collective."""
    if dist.is_initialized():
        return
    if init_method is None and not {"RANK", "WORLD_SIZE"} <= set(os.environ):
        if require:
            raise RuntimeError(
                "no process group to join: run under torchrun or pass "
                "init_method, rank and world_size")
        return
    if backend not in ("nccl", "gloo"):
        raise ValueError(
            f"backend {backend!r}: name it, 'nccl' where each rank owns a "
            "card, 'gloo' for CPU ranks or ranks sharing one card")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kwargs = {k: v for k, v in (("init_method", init_method), ("rank", rank),
                                ("world_size", world_size)) if v is not None}
    if timeout is not None:
        kwargs["timeout"] = timeout if isinstance(timeout, datetime.timedelta) \
            else datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, **kwargs)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (params x data) grid of ranks, data the inner
    axis: rank = params_index * data + data_index.  ``data_group`` holds the
    ranks that share this rank's λ slice (its row), ``params_group`` those
    that share its events and injections (its column); both None where no
    process group exists, which only a single-rank axis allows
    (``log_like_batch_sharded`` checks) or a test that cuts every shard in
    one process."""

    params: int
    data: int
    rank: int
    device: torch.device
    data_group: object = None
    params_group: object = None

    @property
    def shape(self) -> dict:
        return {PARAMS_AXIS: self.params, DATA_AXIS: self.data}

    @property
    def params_index(self) -> int:
        return self.rank // self.data

    @property
    def data_index(self) -> int:
        return self.rank % self.data


def make_mesh(params: int = 1, data: int | None = None, devices=None,
              hybrid: bool = False) -> Mesh:
    """This rank's (params x data) grid over the ranks of the process group
    (one rank, a 1 x 1 grid, where none was joined).  ``data=None`` takes
    every rank left.  ``devices`` is this rank's device: by default the card
    of its ``LOCAL_RANK`` (raising without one), the CPU only when asked
    (``devices="cpu"``), or a given card, e.g. "cuda:0" for ranks sharing
    one.

    ``hybrid=True`` keeps each data group (the per-batch all-reduces)
    inside one node and lets the params axis cross nodes: the params size
    must be divisible by the node count (``WORLD_SIZE /
    LOCAL_WORLD_SIZE``), and then the grid's layout already does so."""
    joined = dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    if data is None:
        if world % params:
            raise ValueError(f"{world} ranks not divisible by params={params}")
        data = world // params
    if params * data != world:
        raise ValueError(f"mesh {params}x{data} != {world} ranks")
    if hybrid:
        nodes = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if params % nodes:
            raise ValueError(
                f"hybrid mesh needs params ({params}) divisible by the node "
                f"count ({nodes}) so that each data group stays in one node")
    device = resolve_device(
        f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}" if devices is None
        else devices)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for rank {rank}: pass devices='cpu'")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    if joined and dist.get_backend() == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend all-reduces CUDA tensors only")
    groups = {}
    if joined:
        # every rank creates every group, in the same order
        for p in range(params):
            g = dist.new_group([p * data + d for d in range(data)])
            if p == rank // data:
                groups["data_group"] = g
        for d in range(data):
            g = dist.new_group([p * data + d for p in range(params)])
            if d == rank % data:
                groups["params_group"] = g
    return Mesh(params, data, rank, device, **groups)


# ---------------------------------------------------------------------------
# Padding and cutting
# ---------------------------------------------------------------------------

def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _event_slice(hl: HyperLikelihood, start: int, stop: int
                 ) -> HyperLikelihood:
    """Events [start, stop) of ``hl`` padded past its last event: a padding
    event copies the last event (edge replication: every kernel's input
    stays finite) and is masked out."""
    n = hl.n_events
    pos = torch.arange(start, stop, device=hl.z_grids.device)
    idx = pos.clamp(max=n - 1)
    mask = pos < n
    if hl.event_mask is not None:
        mask = mask & hl.event_mask[idx]
    return hl.take_events(idx, mask)


def pad_events(hl: HyperLikelihood, multiple: int) -> HyperLikelihood:
    """Pad the event axis to a multiple of ``multiple`` (the data size).
    Padding events copy the last event and are masked out of the sum of
    log numerators and of the real-event count, so log L is unchanged.
    (The JAX package pads to 8 x data for its Pallas tile, which the port
    has no use for.)"""
    return _event_slice(hl, 0, _round_up(hl.n_events, multiple))


def pad_injections(sel: SelectionFunction, multiple: int) -> SelectionFunction:
    """Pad the injection axis to a multiple of ``multiple``; padding
    injections have m1det = m2det = 0.01, below every mass model's support,
    and dL = p_draw = 1, so their rate is exactly zero and N_exp is
    unchanged."""
    n = sel.dL.shape[0]
    return sel.take_injections(0, _round_up(n, multiple))


class ShardedHyperLikelihood(nn.Module):
    """One rank's shard of a hyper-likelihood: its events (``local``, a
    ``HyperLikelihood`` over them, padding masked) and its injections, the
    global count of real events, and the mesh.  ``log_like_batch`` and
    ``log_like`` run the collective path, so ``make_vector_log_prob`` and
    the samplers take it as they take a ``HyperLikelihood``."""

    def __init__(self, local: HyperLikelihood, mesh: Mesh, n_events_real: int):
        super().__init__()
        self.local = local
        self.mesh = mesh
        self.n_events_real = int(n_events_real)

    @property
    def population(self):
        return self.local.population

    def partial_sums(self, pop_b, place: tuple[int, int] | None = None
                     ) -> torch.Tensor:
        """The shard's part of a batch at the λ batch ``pop_b``: (3, L), its
        summed log numerators of real events and the selection's two sums,
        each a sum over the shard's events or injections (what the data
        group all-reduces); ``place`` = (n, start): ``pop_b`` is rows start
        .. start + L of an n-row batch, summed in place
        (``pytree.batch_sum``)."""
        local = self.local
        s1, s2 = local.selection.partial_sums(pop_b, place)
        return torch.stack([local.sum_log_evs(local.batch_numerators(pop_b),
                                              place), s1, s2])

    def finish(self, pop_b, sums: torch.Tensor) -> torch.Tensor:
        """log L (L,) from the data group's summed ``partial_sums`` and the
        global count of real events."""
        n_exp = self.local.selection.n_exp_from_sums(pop_b, sums[1], sums[2])
        return self.local.finish(pop_b, sums[0], n_exp, self.n_events_real)

    def log_like_batch(self, hyper_batch: dict) -> torch.Tensor:
        return log_like_batch_sharded(self, hyper_batch, self.mesh)

    def log_like(self, **hyper) -> torch.Tensor:
        """One λ: every rank of a data group's column evaluates it (a batch
        of ``params`` copies)."""
        n = self.mesh.params
        return self.log_like_batch({k: [v] * n for k, v in hyper.items()})[0]


def shard_hyperlikelihood(hl: HyperLikelihood, mesh: Mesh
                          ) -> ShardedHyperLikelihood:
    """This rank's shard of ``hl``: the events and injections of its data
    index, after padding both axes to a multiple of the data size (the
    padded whole is never built).  Every buffer indexed by event is cut by
    its kind's list (``HyperLikelihood.event_buffers``), the catalog's
    event fields by name; the rest is shared.  The shard is cut where
    ``hl`` lies and moved to the mesh's device (``hl`` itself stays: one
    built on the host puts only the shard on the card)."""
    d, n_data = mesh.data_index, mesh.data
    e_loc = _round_up(hl.n_events, n_data) // n_data
    local = _event_slice(hl, d * e_loc, (d + 1) * e_loc)
    i_loc = _round_up(hl.selection.dL.shape[0], n_data) // n_data
    local.selection = hl.selection.take_injections(d * i_loc, (d + 1) * i_loc)
    return ShardedHyperLikelihood(local.to(mesh.device), mesh, hl.n_events_real)


# ---------------------------------------------------------------------------
# The batch over the grid
# ---------------------------------------------------------------------------

def _all_reduce(t: torch.Tensor, group, size: int) -> None:
    """SUM over ``group`` in place; a single-rank axis without a group is
    the identity."""
    if group is None:
        if size > 1:
            raise RuntimeError(
                f"a mesh axis of {size} ranks has no process group "
                "(make_mesh after init_distributed)")
        return
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)


def _refuse_grad(tensors) -> None:
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the sharded batch carries no gradient: its all-reduces are not "
            "differentiated (ROADMAP.md §1 item 18); evaluate it under "
            "torch.no_grad() or differentiate the unsharded HyperLikelihood")


def log_like_batch_sharded(hl: ShardedHyperLikelihood, hyper_batch: dict,
                           mesh: Mesh) -> torch.Tensor:
    """Log L of a λ batch (dict of equal-length 1-D arrays) over the grid:
    the batch split over the params axis, the data over the data axis (the
    reference's 'both' scheme).

    Each rank evaluates its slice of the batch on its events and
    injections, each sum over events or injections taken at the slice's
    place in the whole batch (so with data = 1 every rank gets the single
    process's bits); the data group all-reduces (SUM) the per-λ sums of log
    numerators and the selection's two sums in one tensor; each rank
    finishes with ``n_exp_from_sums`` and the global real-event count
    (fixed at shard time); then the params group all-reduces an (L,)
    tensor of -0.0 in which each rank wrote its slice (-0.0 is the exact
    additive identity, so every bit is kept), and every rank returns the
    same (L,).  The batch size must be a multiple of the params size."""
    if not isinstance(hl, ShardedHyperLikelihood) or hl.mesh is not mesh:
        raise ValueError("hl must be shard_hyperlikelihood(..., mesh) of this mesh")
    _refuse_grad(hyper_batch.values())
    ref = hl.population.cosmo.H0
    batch = {k: torch.as_tensor(v, dtype=ref.dtype, device=ref.device).reshape(-1)
             for k, v in hyper_batch.items()}
    n = {v.shape[0] for v in batch.values()}
    if len(n) != 1:
        raise ValueError(f"inconsistent λ batch lengths {sorted(n)}")
    n = n.pop()
    if n % mesh.params:
        raise ValueError(f"batch of {n} not divisible by params={mesh.params}")
    part = slice(mesh.params_index * (n // mesh.params),
                 (mesh.params_index + 1) * (n // mesh.params))
    pop_b = hl.population.update_batch({k: v[part] for k, v in batch.items()})
    sums = hl.partial_sums(pop_b, place=(n, part.start))
    _refuse_grad([sums])
    _all_reduce(sums, mesh.data_group, mesh.data)
    out = torch.full((n,), -0.0, dtype=sums.dtype, device=sums.device)
    out[part] = hl.finish(pop_b, sums)
    _all_reduce(out, mesh.params_group, mesh.params)
    return out
