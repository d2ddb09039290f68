"""Process groups, row-halo exchange and byte accounting for the sharded frame.

The counterpart of the JAX package's parallel/sharding.py over
``torch.distributed``: a :class:`RowGroup` (:func:`make_group`) in place of
its mesh, :func:`exchange_row_halo` by point-to-point sends to the row
neighbours in place of ``ppermute``, :func:`reproject_rows_sharded` with its
two branches (a row window, or an all-gather beyond it) and the
:class:`CommLedger` of bytes each interior rank moves a frame.

Transport: every collective sends the tensors it is given over the group's
backend, which the caller names. On NCCL they stay on the card. Gloo cannot
send CUDA tensors point to point, so on gloo a CUDA tensor goes through a
pinned host buffer each way; the rule keys on the group's backend and
nothing falls back to another. One card cannot hold two NCCL ranks, so on a
single card the ranks share it over gloo.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing
import os
import tempfile
import time

import torch
import torch.distributed as dist

from real_time_path_tracing_with_spatiotemporal_filtering_torch.ops import atrous
from real_time_path_tracing_with_spatiotemporal_filtering_torch.utils.device import resolve

ROW_AXIS = "rows"

# Row half-window of the reprojection's fast path (the JAX package's, which
# matches its Pallas blend window, |dy| <= 2 on its measured orbits):
# consecutive-frame motion moves a surface point a few rows at most, so the
# history gather needs this many neighbour rows a side.
REPROJ_HALO_ROWS = 4


@dataclasses.dataclass
class RowGroup:
    """The default process group as it shards a frame's rows: this
    process's rank (its slab is rows [rank * H / n, (rank + 1) * H / n)),
    the group's size, the device its tensors live on and the backend that
    moves them.
    ``comm_s`` adds up the host seconds spent in this module's collectives,
    staging included."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    comm_s: float = 0.0

    @property
    def staged(self) -> bool:
        """Whether CUDA tensors go through host buffers (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def make_group(backend: str, rank: int | None = None, world_size: int | None = None,
               init_method: str | None = None, device=None,
               timeout: float = 60.0) -> RowGroup:
    """The :class:`RowGroup` of this process (the counterpart of
    ``make_mesh``). Initialises the default process group unless it is
    already up: from ``torchrun``'s environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) when ``rank``, ``world_size`` and
    ``init_method`` are not given, else from them (``file://`` or
    ``tcp://`` init methods). ``timeout``: seconds a collective may wait,
    so that a lost rank fails the others. ``device``: default the card,
    ``cuda:(LOCAL_RANK mod the cards present)``, so that ranks on one card
    share it; pass "cpu" to run the plain versions."""
    if not dist.is_initialized():
        if rank is None:
            rank = int(os.environ["RANK"])
        if world_size is None:
            world_size = int(os.environ["WORLD_SIZE"])
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
    got = dist.get_backend()
    if got != backend:
        raise ValueError(f"the process group runs {got}, not {backend}")
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return RowGroup(dist.get_rank(), dist.get_world_size(), dev, backend)


def close_group() -> None:
    """Tear down the default process group, if it is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


class CommLedger:
    """Bytes each interior rank moves a frame, as the JAX package's
    CommLedger counts them, from the shapes of the collectives:

    - ``halo_bytes``: bytes sent to the row neighbours (every a-trous,
      variance, box-filter and upsample halo, and the reprojection
      windows): the steady-state traffic;
    - ``reproj_halo_bytes``: the share of ``halo_bytes`` that the
      reprojection windows move (what the all-gather would replace);
    - ``gather_fallback_bytes``: what each rank would receive if every
      reprojection all-gathered, (n - 1) / n of each plane;
    - ``gather_bytes``: what the all-gathers moved this frame (0 while the
      motion stays in the window; ``gather_fallback_bytes`` on a cut).

    The sharded frame zeroes them at the start of each frame; every rank
    reports the same numbers."""

    def __init__(self):
        self.reset_static()
        self.gather_bytes = 0

    def reset_static(self) -> None:
        self.halo_bytes = 0
        self.reproj_halo_bytes = 0
        self.gather_fallback_bytes = 0

    def _add_halo(self, x: torch.Tensor, halo: int, reproj: bool) -> None:
        nbytes = 2 * halo * math.prod(x.shape[1:]) * x.element_size()
        self.halo_bytes += nbytes
        if reproj:
            self.reproj_halo_bytes += nbytes

    def _add_gather(self, x: torch.Tensor, n: int, small: bool) -> None:
        nbytes = (n - 1) * math.prod(x.shape) * x.element_size()
        self.gather_fallback_bytes += nbytes
        if not small:
            self.gather_bytes += nbytes


def _host(t: torch.Tensor, group: RowGroup) -> torch.Tensor:
    """``t`` as the backend sends it: a pinned host copy on gloo for CUDA
    tensors, else ``t`` itself, contiguous."""
    if group.staged:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf
    return t.contiguous()


def _buffer(shape, dtype, group: RowGroup) -> torch.Tensor:
    """A receive buffer the backend can write."""
    if group.staged:
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    return torch.empty(shape, dtype=dtype, device=group.device)


def _back(t: torch.Tensor, group: RowGroup) -> torch.Tensor:
    return t.to(group.device) if group.staged else t


def exchange_row_halo(x: torch.Tensor, halo: int, group: RowGroup, ledger=None) -> torch.Tensor:
    """``x`` (this rank's rows) padded with ``halo`` rows of each row
    neighbour: the last rows of the rank above on top, the first rows of the
    rank below underneath, sent point to point in one batch; at the frame's
    top and bottom the edge row repeats, which reproduces the single-device
    filter's pixel clamp (temporalFiltering.comp.glsl:136). Needs at least
    ``halo`` local rows."""
    if x.shape[0] < halo:
        raise ValueError(f"shard has {x.shape[0]} rows < halo {halo}; use fewer ranks")
    if ledger is not None:
        ledger._add_halo(x, halo, reproj=False)
    t0 = time.perf_counter()
    r, n = group.rank, group.world_size
    shape = (halo, *x.shape[1:])
    ops, above, below = [], None, None
    if r > 0:
        above = _buffer(shape, x.dtype, group)
        ops += [dist.P2POp(dist.isend, _host(x[:halo], group), r - 1),
                dist.P2POp(dist.irecv, above, r - 1)]
    if r < n - 1:
        below = _buffer(shape, x.dtype, group)
        ops += [dist.P2POp(dist.isend, _host(x[-halo:], group), r + 1),
                dist.P2POp(dist.irecv, below, r + 1)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    top = x[:1].expand(shape) if above is None else _back(above, group)
    bottom = x[-1:].expand(shape) if below is None else _back(below, group)
    out = torch.cat([top, x, bottom])
    group.comm_s += time.perf_counter() - t0
    return out


def all_gather_rows(x: torch.Tensor, group: RowGroup) -> torch.Tensor:
    """The frame's rows: every rank's ``x``, in rank order (equal shapes)."""
    t0 = time.perf_counter()
    parts = [_buffer(x.shape, x.dtype, group) for _ in range(group.world_size)]
    dist.all_gather(parts, _host(x, group))
    out = _back(torch.cat(parts), group)
    group.comm_s += time.perf_counter() - t0
    return out


def window_fits(prev_y: torch.Tensor, row_offset: int, group: RowGroup,
                halo: int = REPROJ_HALO_ROWS) -> bool:
    """Whether every rank's backprojection stays within ``halo`` rows of its
    own pixel (|prev_y - y| <= halo): the branch of
    :func:`reproject_rows_sharded`, the same on every rank (an all-reduce
    MIN). Every history plane of a frame shares prev_y, so a frame decides
    it once: one all-reduce and one host read."""
    own = torch.arange(prev_y.shape[0], device=prev_y.device)[:, None] + row_offset
    local = (prev_y - own).abs().le(halo).all().to(torch.int32).reshape(1)
    t0 = time.perf_counter()
    flag = _host(local, group)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    small = bool(flag.item())
    group.comm_s += time.perf_counter() - t0
    return small


def reprojection_source(plane: torch.Tensor, row_offset: int, small: bool, group: RowGroup,
                        ledger=None, halo: int = REPROJ_HALO_ROWS) -> tuple:
    """Where this rank gathers ``plane``'s history from: (source, row0), the
    source holding the frame's rows from global row row0 on. ``small``
    (:func:`window_fits`): this rank's rows with ``halo`` rows of each
    neighbour (row0 = row_offset - halo); else the all-gathered frame
    (row0 = 0). The ledger counts the window either way, as the JAX
    package's does (its two branches issue the same collectives); the
    branch is settled on the host here, so a frame that all-gathers sends
    no window."""
    if ledger is not None:
        ledger._add_halo(plane, halo, reproj=True)
        ledger._add_gather(plane, group.world_size, small)
    if small:
        return exchange_row_halo(plane, halo, group), row_offset - halo
    return all_gather_rows(plane, group), 0


def reproject_rows_sharded(plane: torch.Tensor, prev_y: torch.Tensor, prev_x: torch.Tensor,
                           row_offset: int, group: RowGroup, halo: int = REPROJ_HALO_ROWS,
                           ledger=None, small: bool | None = None) -> torch.Tensor:
    """``plane_global[prev_y, prev_x]`` for a row-sharded history plane;
    ``prev_y``/``prev_x`` are the GLOBAL backprojected pixels of this rank's
    rows. Through a ``halo``-row window exchanged with the neighbours while
    every rank's motion stays in it, else through one all-gather
    (:func:`reprojection_source`); ``small``: the frame's
    :func:`window_fits`, decided here when not given. Equal, bit for bit,
    to gathering from the all-gathered plane."""
    if small is None:
        small = window_fits(prev_y, row_offset, group, halo)
    source, row0 = reprojection_source(plane, row_offset, small, group, ledger, halo)
    return atrous.gather_window(source, prev_y, prev_x, row0)


def _rank_main(fn, rank: int, world_size: int, store: str, backend: str, device, timeout: float,
               out: str, args: tuple) -> None:
    torch.set_num_threads(1)
    group = make_group(backend, rank, world_size, f"file://{store}", device, timeout)
    try:
        torch.save(fn(group, *args), out)
    finally:
        close_group()


def spawn(fn, world_size: int, *args, backend: str, device=None, timeout: float = 60.0,
          workdir: str | None = None) -> list:
    """Run ``fn(group, *args)`` on ``world_size`` ranks, each a fresh
    process with one torch thread, joined by a FileStore in ``workdir``
    (default: a temporary directory); returns each rank's result (saved
    with ``torch.save``) in rank order. ``fn`` must be importable by the
    children (a module's top-level function). A rank that fails stops the
    others; ``timeout`` bounds each collective's wait."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, store, backend, device,
                                                      timeout, outs[r], args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"ranks {failed} of {world_size} failed "
                               f"(exit codes {[procs[r].exitcode for r in failed]})")
        return [torch.load(o, weights_only=False) for o in outs]


def exchange_probe(group: RowGroup, plane: torch.Tensor, halos, backprojections) -> dict:
    """This rank's side of the collectives on a frame-sized ``plane`` (the
    same on every rank): its rows exchanged at each of ``halos``, and
    reprojected (:func:`reproject_rows_sharded`) at each global
    (prev_y, prev_x) pair of ``backprojections``, with the branch taken
    (True: the window). A rank function of :func:`spawn`; the tests and
    the card hold the results to an edge-padded plane and a global gather."""
    rows = plane.shape[0] // group.world_size
    row_offset = group.rank * rows
    local = plane[row_offset: row_offset + rows].to(group.device)
    out = {"halo": [exchange_row_halo(local, h, group).cpu() for h in halos],
           "reprojected": [], "window": []}
    for prev_y, prev_x in backprojections:
        py = prev_y[row_offset: row_offset + rows].to(group.device)
        px = prev_x[row_offset: row_offset + rows].to(group.device)
        small = window_fits(py, row_offset, group)
        out["window"].append(small)
        out["reprojected"].append(
            reproject_rows_sharded(local, py, px, row_offset, group, small=small).cpu())
    return out
