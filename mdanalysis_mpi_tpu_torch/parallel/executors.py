"""Execution backends of the port.

An analysis (:class:`~mdanalysis_mpi_tpu_torch.analysis.base.AnalysisBase`)
exposes ``_single_frame(ts)`` + ``_serial_summary()`` (host oracle path)
and ``_batch_fn()`` / ``_batch_params()`` / ``_batch_select()`` with a
``_device_fold_fn`` merge (device batch path); the executors below
schedule those over the trajectory:

- :class:`SerialExecutor` — per-frame NumPy loop in float64; the
  reference's single-rank behavior and the differential-test oracle.
- :class:`TorchExecutor` — single device: frame blocks staged on the
  host (float32, int16, int8 or delta wire formats), copied to the
  device, one batch function per block, partials folded ON the device
  in float32 with the analysis' ``_device_fold_fn`` (e.g. the Chan
  moment merge), so nothing returns to the host until the user reads a
  result.
- :class:`MeshExecutor` — data-parallel over a list of devices and,
  under ``torch.distributed``, over processes: each device runs the
  single-device batch function on its shard of every batch and the
  per-device partials merge through the analysis' ``_device_combine``
  (the reference's ``Allreduce``, RMSF.py:110).
- :class:`~mdanalysis_mpi_tpu_torch.parallel.mpi.MPIExecutor` — the
  reference's mpi4py ranks, each running the serial loop on its frame
  block.

Scan-folded dispatch (``scan_k``, the JAX package's ``lax.scan`` over a
group of cached blocks, ``docs/DISPATCH.md``): with a
:class:`DeviceBlockCache`, the blocks of a run are grouped ``scan_k``
at a time; a group staged by an earlier pass is one cache entry (its
blocks stacked on the device) and is dispatched once.  On a CUDA
device that dispatch runs eagerly at the group's first hit and is
from its second hit on one captured CUDA graph of the group's kernel
sequence — the batch function over its blocks plus the fold — kept
with the cache entry and replayed; on the CPU the sequence always runs
eagerly.  Each group
folds its blocks into the running total one by one, in the per-block
schedule's order, so ``scan_k=K`` gives exactly the per-block result.

Also here, as in the JAX package: the prestage cold schedules
(``prestage=True``: decode-then-wire, the copies on an ``mdtpu-wire``
thread), the reliability sites of the batch loop (retry, deadline,
corrupt-frame salvage; :mod:`~mdanalysis_mpi_tpu_torch.reliability.
policy`), stage-time integrity fingerprints and the cache scrub,
``warmup``/``stage`` ahead of a run and :func:`warmup_analysis` /
:func:`stage_analysis`.
"""

from __future__ import annotations

import os as _os
import time as _time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.device import resolve_device
from mdanalysis_mpi_tpu_torch.io.base import BlockCache, sel_fingerprint
from mdanalysis_mpi_tpu_torch.obs import prof as _prof
from mdanalysis_mpi_tpu_torch.obs import spans as _spans
from mdanalysis_mpi_tpu_torch.parallel.partition import (iter_batches,
                                                         pad_batch)
from mdanalysis_mpi_tpu_torch.reliability import faults as _faults
from mdanalysis_mpi_tpu_torch.staging import (quantize_block,
                                              quantize_block_delta)
from mdanalysis_mpi_tpu_torch.utils import compile_cache as _cc
from mdanalysis_mpi_tpu_torch.utils import integrity as _integrity
from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS

#: Resolved ``scan_k`` of the most recent batch run (1 = per-block
#: schedule), and the number of batch runs so far (a run report reads
#: ``LAST_SCAN_K`` only when a batch run happened inside it).
#: Telemetry only (``obs.report`` discloses it beside the dispatch
#: count); never part of the results contract.
LAST_SCAN_K = 1
BATCH_RUNS = 0

#: Stage-time integrity fingerprints (docs/RELIABILITY.md §5): per-array
#: host CRCs of every staged block, recorded beside its cache entry so
#: :meth:`DeviceBlockCache.scrub` can re-fetch and compare.
#: ``MDTPU_INTEGRITY_FINGERPRINTS=0`` turns them off.
_INTEGRITY_FINGERPRINTS = _os.environ.get(
    "MDTPU_INTEGRITY_FINGERPRINTS", "1") not in ("0", "false", "no")


def _uniform_stride(frames) -> int | None:
    """The constant positive stride of ``frames``, or None.  Strided
    windows (``run(step=N)``) then ride the readers' bulk ``read_block``
    instead of per-frame reads."""
    if len(frames) < 2:
        return 1
    step = frames[1] - frames[0]
    if step < 1:
        return None
    if frames[-1] - frames[0] == step * (len(frames) - 1):
        it = iter(frames)
        prev = next(it)
        for f in it:
            if f - prev != step:
                return None
            prev = f
        return step
    return None


def _stage(reader, frames: list[int], sel_idx):
    """Read ``frames`` → (float32 (b, S, 3), boxes (b, 6) or None) with
    the selection gather pushed into the reader."""
    if len(frames) == 0:
        n = reader.n_atoms if sel_idx is None else len(sel_idx)
        return np.empty((0, n, 3), dtype=np.float32), None
    stride = _uniform_stride(frames)
    if stride is not None:
        return reader.read_block(frames[0], frames[-1] + 1, sel=sel_idx,
                                 step=stride)
    tss = [reader[i] for i in frames]
    block = np.stack([ts.positions for ts in tss])
    boxes = None
    for j, ts in enumerate(tss):
        if ts.dimensions is not None:
            if boxes is None:
                boxes = np.zeros((len(tss), 6), dtype=np.float32)
            boxes[j] = ts.dimensions
    if sel_idx is not None:
        block = block[:, sel_idx]
    return block, boxes


def _dequant_wrapper(fn):
    """Wrap batch function ``fn(params, batch_f32, boxes, mask)`` as
    ``g((sel, params), batch_q, inv_scale, boxes, mask)``: dequantize on
    the device (and gather the selection there when ``sel`` is not
    None)."""
    def g(wrapped_params, q, inv_scale, boxes, mask):
        sel, params = wrapped_params
        x = q.to(torch.float32) * inv_scale
        if sel is not None:
            x = x[:, sel]
        return fn(params, x, boxes, mask)

    return g


def _delta_wrapper(fn):
    """Wrap batch function ``fn(params, batch_f32, boxes, mask)`` as
    ``g((sel, params), res_i8, key_i16, inv_abs, inv_res, boxes, mask)``:
    reconstruct the block on the device — keyframe dequant + one
    cumulative sum of the scaled residuals."""
    def g(wrapped_params, res, key, inv_abs, inv_res, boxes, mask):
        sel, params = wrapped_params
        x = (key.to(torch.float32) * inv_abs
             + torch.cumsum(res.to(torch.float32) * inv_res, dim=0))
        if sel is not None:
            x = x[:, sel]
        return fn(params, x, boxes, mask)

    return g


def _quantized_native(analysis, transfer_dtype: str):
    """Analysis-provided quantized-native batch function, or None.

    An analysis may implement ``_quantized_batch(transfer_dtype)``
    returning ``(fn, params, sel_idx)`` where ``fn(params, q,
    inv_scale, boxes, mask)`` consumes the staged quantized block
    directly — the fused aligned-moments path (ops/fused_rmsf.py).
    None keeps the generic dequant-wrapper path."""
    get = getattr(analysis, "_quantized_batch", None)
    if get is None:
        return None
    return get(transfer_dtype)


def _validate_transfer_dtype(transfer_dtype: str) -> None:
    if transfer_dtype not in ("float32", "int16", "int8", "delta"):
        raise ValueError(
            f"transfer_dtype must be 'float32', 'int16', 'int8' or "
            f"'delta', got {transfer_dtype!r}")


def _quant_mode(transfer_dtype: str):
    """Executor transfer dtype → stage_block/stage_cached quantize arg
    (None for the float32 path)."""
    return None if transfer_dtype == "float32" else transfer_dtype


def reader_fingerprint(reader):
    """The leading element of every staged-block cache key: a reader's
    identity in the shared cache's key namespace."""
    return getattr(reader, "_path", None) or id(reader)


def _block_nbytes(bs: int, sel_idx, n_atoms: int,
                  transfer_dtype: str) -> int:
    """Estimated staged bytes of one (bs, S, 3) block — the auto
    ``scan_k`` policy's unit (boxes, mask and keyframes are noise at
    these shapes)."""
    s = n_atoms if sel_idx is None else len(sel_idx)
    per = {"float32": 4, "int16": 2, "int8": 1, "delta": 1}[transfer_dtype]
    return bs * s * 3 * per


def _resolve_scan_k(setting, cache, n_blocks: int,
                    block_nbytes: int) -> int:
    """Effective scan group size for this run (the JAX package's
    ``_resolve_scan_k``).

    ``setting``: the executor's ``scan_k`` (None defers to env
    ``MDTPU_SCAN_K``, default ``"auto"``).  Auto folds ALL of the run's
    blocks into one group up to a device-memory budget, by default the
    cache's own byte cap (the stacked groups ARE the cached entries),
    or ``MDTPU_SCAN_HBM_BUDGET`` bytes.  An explicit integer is clamped
    to the block count and the same budget: an over-budget group would
    stack a superblock the cache then rejects.  A
    :class:`DeviceBlockCache` is required: a group is dispatched once
    only as a cached superblock, so a cacheless run resolves to 1."""
    if cache is None:
        return 1
    if setting is None:
        setting = _os.environ.get("MDTPU_SCAN_K", "auto")
    budget = int(_os.environ.get("MDTPU_SCAN_HBM_BUDGET", "0")
                 or 0) or cache.max_bytes
    budget_blocks = max(1, budget // max(block_nbytes, 1))
    if isinstance(setting, str):
        s = setting.strip().lower()
        if s in ("auto", ""):
            return max(1, min(n_blocks, budget_blocks))
        setting = int(s)
    return max(1, min(int(setting), max(n_blocks, 1), budget_blocks))


def _scan_group_sizes(scan_k: int, n_blocks: int):
    """(init_sizes, fused_sizes): the distinct group lengths the scan
    schedule dispatches without (first group) and with a running total
    — what a warmup must run, nothing more."""
    if scan_k <= 1 or n_blocks <= 1:
        return set(), set()
    n_groups = -(-n_blocks // scan_k)
    tail = n_blocks % scan_k
    init_sizes = {scan_k}
    fused_sizes = set()
    if n_groups > 2 or (n_groups == 2 and not tail):
        fused_sizes.add(scan_k)
    if tail and n_groups > 1:
        fused_sizes.add(tail)
    return init_sizes, fused_sizes


class _Scalars(tuple):
    """The host scalars (per-block inverse scales) of a stacked group,
    one a block: each rides its block's launch as it did unstacked."""


def _stack_staged(blocks: list):
    """K per-block staged tuples → one stacked tuple with a leading
    block axis (the JAX package's ``_stack_staged``): device tensors
    stack on their device (one copy, paid once on the populating
    pass), host scalars become a :class:`_Scalars`, and a mesh's
    per-device tuples stack device by device."""
    first = blocks[0]
    if isinstance(first, tuple) and not isinstance(first, _Scalars):
        return tuple(_stack_staged([b[i] for b in blocks])
                     for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(blocks)
    return _Scalars(blocks)


def _unstack(stacked, i: int):
    """Block ``i`` of a stacked group, in the per-block tuple's form
    (views into the stacked tensors)."""
    if isinstance(stacked, _Scalars):
        return stacked[i]
    if isinstance(stacked, tuple):
        return tuple(_unstack(x, i) for x in stacked)
    return stacked[i]


def _group_len(stacked) -> int:
    x = stacked
    while isinstance(x, tuple) and not isinstance(x, _Scalars):
        x = x[0]
    return len(x)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)


def _delete_staged(staged) -> None:
    """Release a staged tuple's device memory now (the JAX package's
    ``Array.delete()``): each tensor's storage is resized to nothing
    and goes back to PyTorch's caching allocator, whatever else still
    refers to it.  Kernels already queued on the stream that read it
    finish first: the allocator hands memory out again in stream
    order.  A CPU tensor that borrows a NumPy array's memory is left
    to NumPy."""
    for t in _tensors(staged):
        st = t.untyped_storage()
        if st.resizable():
            st.resize_(0)


def _unalias(out, staged):
    """``out`` with every tensor that shares storage with ``staged``
    copied (a batch function may return one of its inputs, as the
    series functions return the mask): the staged tensors may be
    released (:func:`_delete_staged`) while a result lives on."""
    ptrs = {t.untyped_storage().data_ptr() for t in _tensors(staged)}
    return _unalias_tree(out, ptrs)


def _unalias_tree(x, ptrs):
    # module level, not a closure: a recursive closure is a reference
    # cycle left for the cyclic collector
    if isinstance(x, (tuple, list)):
        return type(x)(_unalias_tree(y, ptrs) for y in x)
    if (isinstance(x, torch.Tensor)
            and x.untyped_storage().data_ptr() in ptrs):
        return x.clone()
    return x


def _is_deleted(t: torch.Tensor) -> bool:
    return t.untyped_storage().nbytes() == 0 and t.numel() > 0


def _host_copy(x):
    """A staged leaf as the host bytes its stage-time fingerprint was
    taken over."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, _Scalars):
        return np.asarray(x, dtype=np.float32)
    return np.float32(x)


class DeviceBlockCache(BlockCache):
    """Device-resident staged-block cache shared across trajectory
    passes: AlignedRMSF's pass 2 reads the blocks pass 1 staged instead
    of re-staging them (the reference re-decodes every frame in pass 2,
    RMSF.py:124).  A byte-capped dict of device tensors (insert until
    ``max_bytes``, then stop; blocks beyond the cap are re-staged).

    Under the scan schedule an entry is a stacked group, and the CUDA
    graph captured over it is kept here, beside it: the graph's static
    inputs are the entry's tensors and its launches carry the entry's
    host scalars, so it is valid for that entry alone.  Every path that
    removes an entry (an overwrite, :meth:`drop`,
    :meth:`evict_unpinned`, :meth:`quarantine`, :meth:`clear`) releases
    the entry's device memory and drops its graphs with it."""

    def __init__(self, max_bytes: int = 4 << 30):
        super().__init__(max_bytes)
        # rotating scrub cursor: bounded scrub passes resume where the
        # last one stopped
        self._scrub_cursor = 0
        # key -> {program tag: _GroupGraph}, for stored entries only
        self._programs: dict = {}

    def put(self, key, value, nbytes: int) -> bool:
        """Insert, releasing the device memory (and the graphs) of any
        entry this overwrites; the read of the old entry and the insert
        run under the cache lock, so two racing puts of one key never
        release the same entry twice."""
        with self._lock:
            old = self._store.get(key)
            stored = super().put(key, value, nbytes)
            if stored:
                self._programs.pop(key, None)
        if stored and old is not None and old is not value:
            _delete_staged(old)
        return stored

    def clear(self) -> None:
        with self._lock:
            super().clear()
            self._programs.clear()

    def drop(self) -> None:
        """Release every cached device tensor and graph now."""
        with self._lock:
            staged_all = list(self._store.values())
            self.clear()
        for staged in staged_all:
            _delete_staged(staged)

    def evict_unpinned(self) -> list:
        """Admission-driven eviction (base semantics) plus the release
        of the evicted entries' device memory and graphs."""
        with self._lock:
            evicted = super().evict_unpinned()
            for key in [k for k in self._programs if k not in self._store]:
                del self._programs[key]
        for staged in evicted:
            _delete_staged(staged)
        return evicted

    def quarantine(self, key, expect) -> bool:
        """Scrub-path removal (base semantics) plus the release of the
        corrupt entry's device memory and graphs, so the re-stage has
        room to land."""
        with self._lock:
            removed = super().quarantine(key, expect)
            if removed:
                self._programs.pop(key, None)
        if removed:
            _delete_staged(expect)
        return removed

    def graphs(self) -> list:
        """Every CUDA graph kept with a stored entry."""
        with self._lock:
            return [p for tags in self._programs.values()
                    for p in tags.values() if isinstance(p, _GroupGraph)]

    def program(self, key, entry, tag):
        """What is kept under ``tag`` with the stored entry ``entry``
        at ``key`` (its graph, or the mark of a first hit), or None.
        Nothing kept with any other value at ``key`` is returned."""
        with self._lock:
            if self._store.get(key) is not entry:
                return None
            return self._programs.get(key, {}).get(tag)

    def put_program(self, key, entry, tag, prog) -> bool:
        """Keep ``prog`` with the entry it belongs to; False
        (nothing kept) when ``key`` no longer stores ``entry``."""
        with self._lock:
            if self._store.get(key) is not entry:
                return False
            self._programs.setdefault(key, {})[tag] = prog
            return True

    def scrub(self, max_entries: int | None = None) -> dict:
        """One SDC-scrub pass (docs/RELIABILITY.md §5): copy every
        fingerprinted entry back to the host, recompute its per-array
        CRCs and compare with the fingerprint taken at stage time.  A
        mismatch — a bit flipped on the copy to the device, in device
        memory or in a stacked group — quarantines the entry (its
        memory and graphs are released), so the next pass re-stages
        clean bytes.  Fetch-heavy: a deliberate readback, run it off
        the hot path.  Returns ``{"checked", "corrupt", "bytes",
        "fetch_errors"}``; outcomes land on the ``mdtpu_scrub_*``
        counters."""
        from mdanalysis_mpi_tpu_torch import obs
        from mdanalysis_mpi_tpu_torch.utils.log import get_logger

        items = self.scrub_items()
        if max_entries is not None and items:
            take = min(max_entries, len(items))
            with self._lock:
                start = self._scrub_cursor % len(items)
                self._scrub_cursor = start + take
            items = (items + items)[start:start + take]
        checked = corrupt = nbytes = fetch_errors = 0
        for key, value, fp in items:
            try:
                actual = _integrity.staged_fingerprint(
                    [_host_copy(x) for x in value])
            except RuntimeError as exc:
                with self._lock:
                    still_stored = self._store.get(key) is value
                if not still_stored:
                    continue
                # the device refused the copy back: the scrubber is
                # blind for this entry and says so
                fetch_errors += 1
                obs.METRICS.inc("mdtpu_scrub_fetch_errors_total")
                get_logger("mdtpu").warning(
                    "scrub could not re-fetch resident block %r "
                    "(%s: %s) — SDC verification is NOT running for "
                    "this entry", self._key_ns(key),
                    type(exc).__name__, exc)
                continue
            checked += 1
            nbytes += sum(t.numel() * t.element_size()
                          for t in _tensors(value))
            if tuple(actual) == tuple(fp):
                continue
            corrupt += 1
            quarantined = self.quarantine(key, value)
            obs.METRICS.inc("mdtpu_scrub_corrupt_total")
            obs.span_event("scrub_corrupt", ns=str(self._key_ns(key)),
                           quarantined=quarantined)
            get_logger("mdtpu").error(
                "SDC detected: cached block %r fails its stage-time "
                "fingerprint%s — the next pass re-stages it",
                self._key_ns(key),
                "" if quarantined else " (already replaced)")
        obs.METRICS.inc("mdtpu_scrub_passes_total")
        if checked:
            obs.METRICS.inc("mdtpu_scrub_blocks_total", checked)
        return {"checked": checked, "corrupt": corrupt, "bytes": nbytes,
                "fetch_errors": fetch_errors}


def _tree_to(tree, device):
    """Params pytree (tuples/lists of arrays, tensors, None) → tensors
    on ``device``."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_to(x, device) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.as_tensor(np.asarray(tree), device=device)


def _clone_tree(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone_tree(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return tree


def _copy_tree(dst, src) -> None:
    if isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_tree(d, s)
    elif isinstance(dst, torch.Tensor):
        dst.copy_(src)


def _array_to(a: np.ndarray, device) -> torch.Tensor:
    """Host array → tensor on ``device``; a CUDA copy goes from pinned
    memory as a non-blocking copy on the current stream."""
    if not a.flags["C_CONTIGUOUS"] or not a.flags["WRITEABLE"]:
        a = np.array(a, order="C")
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _put_staged(staged, device):
    """Place a host-staged tuple on ``device``: arrays become tensors;
    a scalar inverse scale stays a host float (it rides the launch)."""
    return tuple(float(x) if np.ndim(x) == 0 else _array_to(x, device)
                 for x in staged)


def _cat_partials(parts):
    first = parts[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_cat_partials([p[i] for p in parts])
                           for i in range(len(first)))
    return torch.cat(parts, dim=0)


def _fold_group(fn, fold, params, stacked, total):
    """A group's kernel sequence: the batch function over its blocks in
    order, each output folded into the running ``total`` (seeded from
    block 0's output when there is none) — the per-block schedule's
    ops in its order.  Series analyses (``fold`` None) get the blocks'
    outputs as a list."""
    outs = []
    acc = total
    for i in range(_group_len(stacked)):
        out = fn(params, *_unstack(stacked, i))
        if fold is None:
            outs.append(out)
        else:
            acc = out if acc is None else fold(acc, out)
    return outs if fold is None else acc


class _GroupGraph:
    """One captured CUDA graph of a scan group's kernel sequence.

    The params (and the running total a later group folds into) are
    copied into static buffers allocated before the capture, and the
    capture runs on a side stream in thread-local mode, so the staging
    thread's copies go on meanwhile; the graph's allocations come from
    its own memory pool.  :meth:`replay` copies the run's params and
    total in, replays on the current stream and hands back copies of
    the static outputs, so a later replay never changes a result
    already handed out.  A failed capture raises; nothing falls back to
    eager dispatch."""

    #: keep the captured ``cudaGraph_t`` beside the executable
    #: (``graph.raw_cuda_graph()``); set only while the capture
    #: contracts of :mod:`~mdanalysis_mpi_tpu_torch.lint.graphcontracts`
    #: probe a run, to read its nodes
    keep_graph = False

    def __init__(self, body, params, total, device):
        from mdanalysis_mpi_tpu_torch import _build

        t0 = _time.perf_counter()
        self.params = _clone_tree(params)
        self.total = _clone_tree(total)
        self.graph = (torch.cuda.CUDAGraph(keep_graph=True)
                      if self.keep_graph else torch.cuda.CUDAGraph())
        with torch.cuda.device(device):
            cur = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(cur)
            with torch.cuda.stream(side), _build.recording() as launches:
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.out = body(self.params, self.total)
                except BaseException:
                    try:
                        self.graph.capture_end()
                    except RuntimeError:
                        pass        # the capture is invalid either way
                    raise
                self.graph.capture_end()
            if self.keep_graph:
                self.graph.instantiate()
            cur.wait_stream(side)
        # the hand kernels' launches inside the graph, counted at each
        # replay (where they run)
        self.launches = tuple(launches)
        self.seconds = _time.perf_counter() - t0

    def replay(self, params, total, device):
        with torch.cuda.device(device):
            _copy_tree(self.params, params)
            if total is not None:
                _copy_tree(self.total, total)
            self.graph.replay()
            out = _clone_tree(self.out)
        for wrapper in self.launches:
            wrapper.launches += 1
        return out


#: kept with a cache entry whose group was hit once: its next hit
#: captures the graph
_HIT_ONCE = "hit once"


def _run_group(cache, key, entry, tag, body, params, total, device,
               capture: bool = True):
    """Dispatch one cached group.  Elsewhere than on a CUDA device, and
    at the group's first hit on one, run ``body`` eagerly; from its
    second hit on, replay its graph (captured then and kept with the
    cache entry).  A capture costs more than one eager run of the
    group, so a run repeated only once never pays for one.  With
    ``capture`` False (a batch function that waits on the device from
    the host, which no graph can capture) the group always runs
    eagerly."""
    if device.type != "cuda" or not capture:
        return body(params, total)
    prog = cache.program(key, entry, tag)
    if prog is None:
        cache.put_program(key, entry, tag, _HIT_ONCE)
        return body(params, total)
    captured = prog is _HIT_ONCE
    if captured:
        prog = _GroupGraph(body, params, total, device)
        cache.put_program(key, entry, tag, prog)
    _cc.note_graph(captured, prog.seconds if captured else 0.0)
    return prog.replay(params, total, device)


def _run_batches(analysis, reader, frames, bs, call, sel_idx, device,
                 cache: "DeviceBlockCache | None" = None, quantize=None,
                 layout: str = "interleaved", engine: str = "generic",
                 put=None, local_divisor: int = 1, local_index: int = 0,
                 delta_anchors: int = 1, device_key=None,
                 reliability=None, prestage: bool = False,
                 scan_k: int = 1, scan=None, stage_only: bool = False):
    """Shared batch loop: stage on the host → copy to the device → run
    the batch function → fold the partials on the device (the JAX
    package's ``_run_batches``).

    The host staging of block i+1 runs on a helper thread while block i
    is consumed.  Partials never leave the device: results are folded
    with the analysis' ``_device_fold_fn`` (reductions) or concatenated
    along the frame axis at the end (per-frame series).  With
    ``engine='fused'`` every consumed block is counted in
    ``mdtpu_fused_blocks_total``.

    ``scan_k > 1`` with ``scan`` (``scan(key, stacked, total)``, the
    group dispatch the executor builds) activates the scan-folded
    schedule: blocks are grouped ``scan_k`` at a time, a group found in
    the cache is dispatched once, and a missed group runs the per-block
    schedule, then its blocks are stacked on the device into one cache
    entry (keyed with the group length) and the per-block tensors are
    released.  Groups are consumed strictly in schedule order.
    ``scan_k=1`` is the per-block schedule, with the same cache keys.
    ``stage_only`` walks the same schedule and dispatches nothing (the
    executors' ``stage``).

    ``prestage=True`` switches from interleaved staging to
    decode-then-wire: with ``MDTPU_COLD_PIPELINE`` on (the default on a
    host with more than one core) each block's copy to the device runs
    on an ``mdtpu-wire`` thread while the next block decodes, at most
    ``MDTPU_WIRE_WINDOW`` blocks ahead; otherwise chunks of
    ``MDTPU_PRESTAGE_CHUNK`` blocks are staged with no device contact,
    then copied, with a barrier (a wait on the stream) between chunks.
    The copies always go on the caller's stream, the one the batch
    functions launch on.

    ``reliability`` (a :class:`~mdanalysis_mpi_tpu_torch.reliability.
    policy.ReliabilityRuntime`, duck-called so this module never
    imports the policy layer) wraps staging, the copy and the dispatch
    in its retry/backoff/deadline envelope, and validates every staged
    float block (corrupt frames re-read, then skipped with a count, or
    the run aborted).  The fault-injection sites ``stage``, ``bitflip``,
    ``put`` and ``kernel`` fire here (``kernel`` once per dispatch: a
    block, or a whole group).

    The mesh executor passes ``put`` (host-staged tuple → what ``call``
    takes, by default the tuple's tensors on ``device`` on the caller's
    stream) and ``device_key`` (the cache key's device part: its device
    list and this rank's place, which fix the shards, the rank's slice
    and the delta anchors).  Under several processes (``local_divisor``
    = the world size) batch bounds stay GLOBAL — every rank walks the
    same batch schedule, so their collectives pair up — and each rank
    stages only its ``local_index``-th ``1/local_divisor`` slice of
    every batch, padded to that size.  Delta staging cuts each staged
    block into ``delta_anchors`` segments, one keyframe each.

    Timed phases (``utils/timers``): ``stage`` (a block's host side,
    the readers' ``gather``/``repack``/``chunk_read`` inside it),
    ``wire`` (``_place``: its fingerprint and copy to the device, on
    every schedule), ``stage_wait`` (the dispatching thread blocked on
    a block's future) and ``dispatch``; ``_place`` counts the host
    bytes it copies in ``mdtpu_staged_bytes_total``."""
    from mdanalysis_mpi_tpu_torch import obs

    global LAST_SCAN_K, BATCH_RUNS
    fold = analysis._device_fold_fn
    total = None
    parts = []
    bounds = list(iter_batches(0, len(frames), bs))
    scan_active = (scan_k > 1 and (scan is not None or stage_only)
                   and len(bounds) > 1)
    if not stage_only:
        LAST_SCAN_K = scan_k if scan_active else 1
        BATCH_RUNS += 1
    rt = reliability
    validate = rt is not None and rt.policy.validate_frames
    sel_fp = sel_fingerprint(sel_idx)
    reader_fp = reader_fingerprint(reader)
    xform_fp = getattr(reader, "transformations", ())
    planar = layout == "planar"
    # the helper threads issue the copies on the caller's stream, the
    # one ``call`` launches on, so a kernel never reads a block before
    # its copy lands
    stream = (torch.cuda.current_stream(device) if device.type == "cuda"
              else None)

    if device_key is None:
        device_key = str(device)
    # stage-time fingerprints describe the host tuple one device
    # receives whole; a mesh's shards are not fingerprinted
    fingerprinting = (_INTEGRITY_FINGERPRINTS and cache is not None
                      and put is None)
    if put is None:
        def put(staged_host):
            if stream is None:
                return _put_staged(staged_host, device)
            with torch.cuda.stream(stream):
                return _put_staged(staged_host, device)

    # a shared cache must never serve blocks staged for another
    # selection, trajectory, batch size, wire format, layout or device;
    # `validate` namespaces resilient runs' entries (their blocks may
    # have salvage-dropped rows); the planar suffix only where planar,
    # so every interleaved key stays what it was
    key_suffix = ("planar",) if planar else ()

    def _key(a, b):
        return (reader_fp, tuple(frames[a:b]), bs, quantize, sel_fp,
                xform_fp, device_key, validate) + key_suffix

    def _host_stage(batch_frames):
        """Host side of one block: read + gather (+ quantize) + pad.
        Returns (staged host tuple, resident nbytes); nbytes is -1 for
        a block salvage shortened (never cached: a later hit would
        skip salvage and leave that run's report blind)."""
        pad_to = bs
        if local_divisor > 1:
            # stage only this rank's slice of the global batch
            pad_to = bs // local_divisor
            batch_frames = batch_frames[local_index * pad_to:
                                        (local_index + 1) * pad_to]
        contiguous = (len(batch_frames) > 0
                      and batch_frames[-1] - batch_frames[0] + 1
                      == len(batch_frames))
        # with a device cache, repeat passes hit the device; the host
        # stage cache serves only when the device cache cannot
        if cache is None or cache.full:
            stage = getattr(reader, "stage_cached", None)
        else:
            stage = getattr(reader, "stage_block", None)
        # delta reads float32 and runs the closed-loop quantizer below
        q_inline = None if quantize == "delta" else quantize
        # validation needs float coordinates: a resilient run stages
        # float32 and quantizes after the check (the JAX package's
        # order)
        q_fused = None if validate else q_inline
        staged_planar = False
        if contiguous and stage is not None:
            if planar and q_fused:
                block, boxes, inv_scale = stage(
                    batch_frames[0], batch_frames[-1] + 1, sel_idx,
                    q_fused, layout="planar")
                staged_planar = True
            else:
                block, boxes, inv_scale = stage(
                    batch_frames[0], batch_frames[-1] + 1, sel_idx,
                    q_fused)
        else:
            with TIMERS.phase("gather"):
                block, boxes = _stage(reader, batch_frames, sel_idx)
            obs.METRICS.inc("mdtpu_stage_blocks_total", path="generic")
            inv_scale = None
        if _faults.plans():
            block = _faults.fire("stage", frames=batch_frames, array=block)
        n_dropped = 0
        if validate:
            healed = len(rt.report.healed_frames)
            block, boxes, n_dropped = rt.salvage_block(
                reader, sel_idx, batch_frames, block, boxes,
                series=fold is None)
            clean = (n_dropped == 0
                     and len(rt.report.healed_frames) == healed)
            if clean and q_inline and contiguous and stage is not None:
                # a block validation left alone stages exactly as a run
                # without the policy stages it (the reader's own
                # quantizer and scale hints: the same bytes); only a
                # block salvage changed is quantized below
                if planar:
                    block, boxes, inv_scale = stage(
                        batch_frames[0], batch_frames[-1] + 1, sel_idx,
                        q_inline, layout="planar")
                    staged_planar = True
                else:
                    block, boxes, inv_scale = stage(
                        batch_frames[0], batch_frames[-1] + 1, sel_idx,
                        q_inline)
        if q_inline and inv_scale is None:
            block, inv_scale = quantize_block(block, q_inline,
                                              layout=layout)
            staged_planar = planar
        n_staged = block.shape[1 if staged_planar else 0]
        if boxes is None:
            boxes = np.zeros((n_staged, 6), dtype=np.float32)
        padded, mask = pad_batch(block, pad_to,
                                 axis=1 if staged_planar else 0)
        boxes_p, _ = pad_batch(np.ascontiguousarray(boxes, np.float32),
                               pad_to)
        if quantize == "delta":
            res, dkey, inv_abs, inv_res = quantize_block_delta(
                padded, delta_anchors, n_valid=n_staged)
            return ((res, dkey, inv_abs, inv_res, boxes_p, mask),
                    -1 if n_dropped else res.nbytes + dkey.nbytes)
        if quantize:
            return ((padded, inv_scale, boxes_p, mask),
                    -1 if n_dropped else padded.nbytes)
        return (padded, boxes_p, mask), -1 if n_dropped else padded.nbytes

    # scan-group fingerprints: gi -> (blocks chained, per-array CRCs);
    # stacking puts each leaf's blocks end to end, so chaining the
    # per-block CRCs equals the stacked entry's fingerprint
    group_fp_acc: dict = {}

    def _place(staged_host, key, nbytes, bi=None):
        """Device side: copy a host-staged tuple to the device and cache
        it (``key=None``, the scan schedule's per-block copies, skips
        the cache: the stacked group is the entry).  The integrity
        boundary too: the fingerprint is taken here, before the copy,
        and the ``bitflip`` fault site fires between the two."""
        fp = None
        if fingerprinting and nbytes >= 0 and not cache.full:
            if key is not None:
                fp = _integrity.staged_fingerprint(staged_host)
            elif scan_active and bi is not None:
                gi = block_group[bi]
                n, crcs = group_fp_acc.get(gi, (0, None))
                group_fp_acc[gi] = (
                    n + 1, _integrity.staged_fingerprint(staged_host, crcs))
        if _faults.plans():
            first = _faults.fire("bitflip", array=staged_host[0])
            if first is not staged_host[0]:
                staged_host = (first,) + tuple(staged_host[1:])

        def _put():
            if _faults.plans():
                _faults.fire("put")
            return put(staged_host)

        obs.METRICS.inc("mdtpu_staged_bytes_total",
                        sum(getattr(x, "nbytes", 0) for x in staged_host))
        staged = _put() if rt is None else rt.op("put", _put)
        if cache is not None and key is not None and nbytes >= 0:
            if cache.put(key, staged, nbytes) and fp is not None:
                cache.note_fingerprint(key, fp, expect=staged)
        return staged

    def _stage_op(batch_frames):
        """_host_stage under the reliability retry/deadline envelope."""
        if rt is None:
            return _host_stage(batch_frames)
        return rt.op("stage", lambda: _host_stage(batch_frames))

    trace_ctx = _spans.current_context()

    def prepare(bi):
        """Host side of one block and its copy (on the prefetch
        thread).  Returns (staged, nbytes); nbytes is 0 for a hit."""
        a, b = bounds[bi]
        key = None if scan_active else _key(a, b)
        if key is not None and cache is not None:
            staged = cache.get(key)
            if staged is not None:
                return staged, 0
        with _spans.saved_context(trace_ctx):
            with TIMERS.phase("stage", lo=a, hi=b):
                staged_host, nbytes = _stage_op(frames[a:b])
            with TIMERS.phase("wire"):
                return _place(staged_host, key, nbytes, bi), nbytes

    def _note_fused_blocks(n: int):
        if engine == "fused":
            obs.METRICS.inc("mdtpu_fused_blocks_total", n)

    def consume(staged):
        nonlocal total
        # continuous-profiler dispatch latency (obs/prof.py): one
        # perf_counter pair per dispatch, only while sampling is on
        pt0 = _time.perf_counter() if _prof.enabled() else None
        with TIMERS.phase("dispatch", scan_k=1, engine=engine):
            def _dispatch():
                if _faults.plans():
                    _faults.fire("kernel")
                return _unalias(call(*staged), staged)

            out = _dispatch() if rt is None else rt.op("kernel", _dispatch)
            if fold is None:
                parts.append(out)
            else:
                total = out if total is None else fold(total, out)
        _note_fused_blocks(1)
        if pt0 is not None:
            _prof.note_dispatch((_time.perf_counter() - pt0) * 1e3,
                                geometry=f"bs{bs}_scan1", engine=engine)

    if scan_active:
        groups = [list(range(lo, min(lo + scan_k, len(bounds))))
                  for lo in range(0, len(bounds), scan_k)]

        def _group_key(g):
            a, b = bounds[g[0]][0], bounds[g[-1]][1]
            # the per-block key's fields plus the group length: a
            # stacked group is never served to another grouping
            return (reader_fp, tuple(frames[a:b]), bs, quantize, sel_fp,
                    xform_fp, device_key, validate, "scan",
                    len(g)) + key_suffix

        group_keys = [_group_key(g) for g in groups]
        group_hits = [cache.get(k) if cache is not None else None
                      for k in group_keys]
        block_group = {bi: gi for gi, g in enumerate(groups) for bi in g}
        miss_blocks = [bi for gi, g in enumerate(groups)
                       if group_hits[gi] is None for bi in g]
        pending: dict = {}
        next_group = 0

        def consume_scan(gi):
            """One dispatch for a whole cached group."""
            nonlocal total
            stacked = group_hits[gi]
            n_blocks = _group_len(stacked)
            pt0 = _time.perf_counter() if _prof.enabled() else None
            with TIMERS.phase("dispatch", scan_k=scan_k, blocks=n_blocks,
                              engine=engine):
                def _dispatch():
                    if _faults.plans():
                        _faults.fire("kernel")
                    return _unalias(scan(group_keys[gi], stacked,
                                         None if fold is None else total),
                                    stacked)

                out = (_dispatch() if rt is None
                       else rt.op("kernel", _dispatch))
                if fold is None:
                    parts.append(out)
                else:
                    total = out
            _note_fused_blocks(n_blocks)
            if pt0 is not None:
                # program geometry = batch size × scan group length
                _prof.note_dispatch(
                    (_time.perf_counter() - pt0) * 1e3,
                    geometry=f"bs{bs}_scan{n_blocks}", engine=engine)

        def _flush_hits_before(gi_limit):
            """Consume, in order, every hit group before ``gi_limit``
            (miss groups move the cursor in _note_block_done)."""
            nonlocal next_group
            while next_group < gi_limit:
                consume_scan(next_group)
                next_group += 1

        def _note_block_done(bi, staged, nbytes):
            """When a missed group's last block is done, stack its
            blocks on the device into the cache entry the next run's
            dispatch reads, and release the per-block tensors."""
            nonlocal next_group
            gi = block_group[bi]
            pending.setdefault(gi, []).append((staged, nbytes))
            if bi != groups[gi][-1]:
                return
            blocks = pending.pop(gi)
            next_group = gi + 1
            fp_n, fp = group_fp_acc.pop(gi, (0, None))
            if (cache is not None and not cache.full
                    and all(nb >= 0 for _, nb in blocks)):
                stacked = _stack_staged([s for s, _ in blocks])
                group_nb = sum(nb for _, nb in blocks)
                if not cache.put(group_keys[gi], stacked, group_nb):
                    _delete_staged(stacked)
                elif fp is not None and fp_n == len(blocks):
                    cache.note_fingerprint(group_keys[gi], fp,
                                           expect=stacked)
            for s, _ in blocks:
                _delete_staged(s)

    seq = miss_blocks if scan_active else list(range(len(bounds)))

    if stage_only:
        staged_blocks = 0
        for bi in seq:
            staged, nbytes = prepare(bi)
            if nbytes:
                staged_blocks += 1
            if scan_active:
                _note_block_done(bi, staged, nbytes)
        return staged_blocks

    def _run_one(bi, staged, nbytes):
        if scan_active:
            _flush_hits_before(block_group[bi])
        consume(staged)
        if scan_active:
            _note_block_done(bi, staged, nbytes)

    window = max(1, int(_os.environ.get("MDTPU_WIRE_WINDOW", "4")))
    if prestage and _cold_pipeline_enabled():
        # decode → wire double-buffered: block i's copy runs on the
        # mdtpu-wire thread while block i+1 decodes here, at most
        # `window` blocks decoded and not yet consumed
        wire_ctx = _spans.current_context()

        def _wire(staged_host, key, nbytes, bi):
            with _spans.saved_context(wire_ctx), TIMERS.phase("wire"):
                return _place(staged_host, key, nbytes, bi)

        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="mdtpu-wire") as wpool:
            futs: dict = {}
            nxt = 0
            for i in range(len(seq)):
                while nxt < len(seq) and nxt - i < window:
                    a, b = bounds[seq[nxt]]
                    key = None if scan_active else _key(a, b)
                    hit = (cache.get(key)
                           if key is not None and cache is not None
                           else None)
                    if hit is not None:
                        futs[nxt] = (None, hit, 0)
                    else:
                        with TIMERS.phase("stage", lo=a, hi=b):
                            sh, nb = _stage_op(frames[a:b])
                        futs[nxt] = (wpool.submit(_wire, sh, key, nb,
                                                  seq[nxt]), None, nb)
                    nxt += 1
                fut, hit, nbytes = futs.pop(i)
                if fut is None:
                    staged = hit
                else:
                    with TIMERS.phase("stage_wait"):
                        staged = fut.result()
                _run_one(seq[i], staged, nbytes)
    elif prestage:
        # chunked decode-then-wire: a chunk of blocks staged with no
        # device contact, then copied `window` at a time, then a
        # barrier before the next chunk decodes
        chunk = max(window,
                    int(_os.environ.get("MDTPU_PRESTAGE_CHUNK", "6")))
        for clo in range(0, len(seq), chunk):
            items: list = []
            for bi in seq[clo:clo + chunk]:
                a, b = bounds[bi]
                key = None if scan_active else _key(a, b)
                hit = (cache.get(key)
                       if key is not None and cache is not None else None)
                if hit is not None:
                    items.append((None, hit, key, 0, bi))
                    continue
                with TIMERS.phase("stage", lo=a, hi=b):
                    staged_host, nbytes = _stage_op(frames[a:b])
                items.append((staged_host, None, key, nbytes, bi))
            placed: dict = {}
            nxt = 0
            wired = False
            for i in range(len(items)):
                while nxt < len(items) and nxt - i < window:
                    staged_host, staged, key, nbytes, bi = items[nxt]
                    if staged is None:
                        with TIMERS.phase("wire"):
                            staged = _place(staged_host, key, nbytes, bi)
                        wired = True
                    placed[nxt] = (staged, nbytes)
                    items[nxt] = None
                    nxt += 1
                staged, nbytes = placed.pop(i)
                _run_one(seq[clo + i], staged, nbytes)
            if wired and stream is not None and clo + chunk < len(seq):
                # chunk barrier: the chunk's copies land before the
                # next chunk decodes (a wait on the stream; nothing
                # reads the chunk's released blocks)
                with TIMERS.phase("wire"):
                    stream.synchronize()
    else:
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(prepare, seq[0]) if seq else None
            for j, bi in enumerate(seq):
                with TIMERS.phase("stage_wait"):
                    staged, nbytes = fut.result()
                if j + 1 < len(seq):
                    fut = pool.submit(prepare, seq[j + 1])
                _run_one(bi, staged, nbytes)
    if scan_active:
        _flush_hits_before(len(groups))
    if fold is not None:
        return total if total is not None else analysis._identity_partials()
    if not parts:
        return analysis._identity_partials()
    return _cat_partials(parts)


def _cold_pipeline_enabled() -> bool:
    """Whether the prestage schedule overlaps decode with the copies on
    the ``mdtpu-wire`` thread (the JAX package's default policy: on for
    a host with more than one core, where the decoder and the copies
    need not share one core).  ``MDTPU_COLD_PIPELINE=0/1`` overrides."""
    pipe = _os.environ.get("MDTPU_COLD_PIPELINE")
    if pipe is not None:
        return pipe not in ("0", "false", "no")
    return (_os.cpu_count() or 1) > 1


class SerialExecutor:
    """Frame-at-a-time host loop (the reference's per-rank body,
    RMSF.py:91-103/123-138, minus MPI).  With ``reliability`` every
    read is validated: a transient or corrupt read is retried, then the
    frame is skipped with a count or the run aborted, per policy."""

    name = "serial"
    # execute() accumulates inside the analysis and returns the full
    # summary, not per-call partials (utils/checkpoint.py refuses it)
    per_call_partials = False
    reliability = None

    def __init__(self, reliability=None):
        if reliability is not None:
            self.reliability = reliability

    def execute(self, analysis, reader, frames, batch_size=None):
        rt = self.reliability
        if rt is None:
            for i in frames:
                analysis._single_frame(reader[i])
            return analysis._serial_summary()
        processed = []
        for i in frames:
            ts = rt.read_frame(reader, i)
            if ts is not None:
                analysis._single_frame(ts)
                processed.append(i)
        if len(processed) != len(frames):
            # per-frame columns (results.frames, time axes) follow the
            # frames that ran
            analysis._frame_indices = processed
            analysis.n_frames = len(processed)
        return analysis._serial_summary()


class _Setup(NamedTuple):
    """What one run dispatches: the batch function (``fn``, wrapped),
    the analysis' own (``base_fn``) and its wrapper (``wrap``: None,
    ``'dequant'`` or ``'delta'``), the params, the staged selection,
    the quantize mode, the staging layout and the engine label."""

    fn: object
    base_fn: object
    wrap: object
    params: object
    sel_idx: object
    quantize: object
    layout: str
    engine: str

    def program_tag(self, fold, role: str, shard: int, params, total):
        """The graph tag of one group program: the unwrapped batch
        function and its wrapper, the fold, the role, the shard, and
        the signatures of the params and of the running total."""
        return (self.base_fn, self.wrap, fold, role, shard,
                _cc.signature(params), _cc.signature(total))


def _batch_setup(analysis, transfer_dtype: str,
                 use_quantized_native: bool = True) -> _Setup:
    """The batch function, params, staged selection, quantize mode,
    staging layout and engine label of one run: the fused
    quantized-native function when the analysis registers one and
    ``use_quantized_native`` (its ``staging_layout`` says whether the
    blocks stage as planar ``(3, B, S)`` planes; engine ``'fused'``),
    else the analysis' batch function behind the dequant or delta
    wrapper (engine ``'generic'``).  Every executor path shares it, so
    ``execute``, ``warmup`` and ``stage`` cannot disagree, and a mesh
    device runs exactly the function a single device runs."""
    quantize = _quant_mode(transfer_dtype)
    qn = (_quantized_native(analysis, transfer_dtype)
          if use_quantized_native else None)
    if qn is not None:
        fn, params, sel_idx = qn
        return _Setup(fn, fn, None, params, sel_idx, quantize,
                      getattr(fn, "staging_layout", "interleaved"), "fused")
    base_fn = analysis._batch_fn()
    params = analysis._batch_params()
    wrap = None
    fn = base_fn
    if transfer_dtype == "delta":
        wrap, fn, params = "delta", _delta_wrapper(base_fn), (None, params)
    elif quantize:
        wrap, fn, params = "dequant", _dequant_wrapper(base_fn), \
            (None, params)
    return _Setup(fn, base_fn, wrap, params, analysis._batch_select(),
                  quantize, "interleaved", "generic")


def _zero_staged(bs: int, n_stage: int, quantize, layout: str,
                 delta_anchors: int = 1):
    """A host-staged tuple of zeros in exactly the shapes and dtypes
    ``_run_batches._host_stage`` produces (the JAX package's
    ``_staged_avals``): what a warmup dispatches."""
    z = np.zeros
    boxes, mask = z((bs, 6), np.float32), z((bs,), np.float32)
    if quantize == "delta":
        return (z((bs, n_stage, 3), np.int8),
                z((delta_anchors, n_stage, 3), np.int16),
                np.ones((delta_anchors, 1, 1), np.float32),
                np.ones((bs, 1, 1), np.float32), boxes, mask)
    if quantize:
        shape = ((3, bs, n_stage) if layout == "planar"
                 else (bs, n_stage, 3))
        return (z(shape, np.dtype(quantize)), np.float32(1.0), boxes, mask)
    return (z((bs, n_stage, 3), np.float32), boxes, mask)


class TorchExecutor:
    """Single-device batch pipeline: stage block → batch function →
    on-device float32 fold across blocks.

    ``device``: ``None`` (the default device, ``cuda``, which must be
    present), ``"cuda"``, ``"cuda:N"`` or ``"cpu"``.  ``transfer_dtype``
    picks the wire format (``float32``, ``int16``, ``int8``,
    ``delta``).  ``block_cache``: a :class:`DeviceBlockCache` shared
    across passes, or None.  ``scan_k``: the scan group size — an int,
    ``"auto"``, or None for ``MDTPU_SCAN_K`` (default auto); it takes
    effect with a block cache (:func:`_resolve_scan_k`).  ``prestage``:
    the decode-then-wire cold schedule.  ``reliability``: a
    :class:`~mdanalysis_mpi_tpu_torch.reliability.policy.
    ReliabilityRuntime`.  ``use_quantized_native=False`` pins the
    generic dequant path even where the analysis registers a fused
    kernel (the degradation chain's fused → generic rung)."""

    name = "torch"
    # execute() returns one partials tree per call — checkpointable
    per_call_partials = True
    reliability = None

    def __init__(self, batch_size: int = 128, device=None,
                 block_cache: DeviceBlockCache | None = None,
                 transfer_dtype: str = "float32", prestage: bool = False,
                 reliability=None, scan_k: "int | str | None" = None,
                 use_quantized_native: bool = True):
        _validate_transfer_dtype(transfer_dtype)
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.block_cache = block_cache
        self.transfer_dtype = transfer_dtype
        self.prestage = prestage
        self.scan_k = scan_k
        self.use_quantized_native = use_quantized_native
        if reliability is not None:
            self.reliability = reliability

    def _setup(self, analysis) -> _Setup:
        return _batch_setup(analysis, self.transfer_dtype,
                            self.use_quantized_native)

    def _scan_k(self, setup, reader, n_frames: int, bs: int) -> int:
        return _resolve_scan_k(
            self.scan_k, self.block_cache, -(-n_frames // bs),
            _block_nbytes(bs, setup.sel_idx, reader.n_atoms,
                          self.transfer_dtype))

    def execute(self, analysis, reader, frames, batch_size=None):
        if getattr(analysis, "_mesh_only", False):
            raise ValueError(
                f"{type(analysis).__name__} uses an atom-sharded ring "
                "kernel (collectives across devices); run it with "
                "backend='mesh'")
        bs = batch_size or self.batch_size
        setup = self._setup(analysis)
        params = _tree_to(setup.params, self.device)
        frames = list(frames)
        scan_k = self._scan_k(setup, reader, len(frames), bs)
        fold = analysis._device_fold_fn
        fn, cache, device = setup.fn, self.block_cache, self.device
        capture = not getattr(analysis, "_host_waits_in_batch", False)

        def scan(key, stacked, total):
            role = ("series" if fold is None
                    else "init" if total is None else "fused")

            def body(p, tot):
                out = _fold_group(fn, fold, p, stacked, tot)
                return out if fold is not None else _cat_partials(out)

            return _run_group(
                cache, key, stacked,
                setup.program_tag(fold, role, 0, params, total), body,
                params, total, device, capture)

        return _run_batches(
            analysis, reader, frames, bs,
            lambda *staged: fn(params, *staged), setup.sel_idx, device,
            cache=cache, quantize=setup.quantize, layout=setup.layout,
            engine=setup.engine, reliability=self.reliability,
            prestage=self.prestage, scan_k=scan_k, scan=scan)

    def warmup(self, analysis, reader, frames, batch_size=None) -> int:
        """Prepare every program ``execute`` would dispatch for this
        geometry (the JAX package's AOT ``warmup``): build and load
        the ``csrc/`` kernel library on a CUDA device, then run the
        batch function, the fold and each scan group length of
        :func:`_scan_group_sizes` once, eagerly, on zero blocks of the
        exact staged shapes, copied through pinned memory as a run
        copies them.  PyTorch runs eagerly, so the library is the one
        program a later run would otherwise build: a run after a
        warmup builds and loads nothing.  It still captures its groups'
        CUDA graphs, since a graph holds the device pointers of the
        cache entry it was captured over.  The caller has resolved the
        frames and run ``analysis._prepare()`` (:func:`warmup_analysis`
        does both).  Returns the number of programs run."""
        if getattr(analysis, "_mesh_only", False):
            return 0
        bs = batch_size or self.batch_size
        try:
            setup = self._setup(analysis)
        except NotImplementedError:
            return 0          # serial-only analysis: nothing to run
        frames = list(frames)
        n_blocks = -(-len(frames) // bs)
        if n_blocks == 0:
            return 0
        if self.device.type == "cuda":
            from mdanalysis_mpi_tpu_torch import _build

            _build.load()
        n_stage = (reader.n_atoms if setup.sel_idx is None
                   else len(setup.sel_idx))
        params = _tree_to(setup.params, self.device)
        staged = _put_staged(_zero_staged(bs, n_stage, setup.quantize,
                                          setup.layout), self.device)
        fn, fold = setup.fn, analysis._device_fold_fn
        td = self.transfer_dtype

        out = fn(params, *staged)
        _cc.note_warmup()
        n = 1
        if fold is not None and n_blocks > 1:
            fold(out, out)
            _cc.note_warmup()
            n += 1
        scan_k = _resolve_scan_k(
            self.scan_k, self.block_cache, n_blocks,
            _block_nbytes(bs, setup.sel_idx, reader.n_atoms, td))
        init_sizes, fused_sizes = _scan_group_sizes(scan_k, n_blocks)
        for k in sorted(init_sizes | fused_sizes):
            stacked = _stack_staged([staged] * k)
            if fold is None:
                _fold_group(fn, None, params, stacked, None)
                _cc.note_warmup()
                n += 1
                continue
            if k in init_sizes:
                _fold_group(fn, fold, params, stacked, None)
                _cc.note_warmup()
                n += 1
            if k in fused_sizes:
                _fold_group(fn, fold, params, stacked, out)
                _cc.note_warmup()
                n += 1
        return n

    def stage(self, analysis, reader, frames, batch_size=None) -> int:
        """Stage this run's blocks into ``block_cache`` without
        dispatching any kernel (the JAX package's scheduler-prefetch
        entry point): the exact schedule ``execute`` walks, same cache
        keys and scan grouping, so a later run over the same window is
        all hits.  Returns the blocks staged (0 without a cache)."""
        if self.block_cache is None or getattr(analysis, "_mesh_only",
                                               False):
            return 0
        bs = batch_size or self.batch_size
        try:
            setup = self._setup(analysis)
        except NotImplementedError:
            return 0
        frames = list(frames)
        return _run_batches(
            analysis, reader, frames, bs, None, setup.sel_idx, self.device,
            cache=self.block_cache, quantize=setup.quantize,
            layout=setup.layout, engine=setup.engine,
            reliability=self.reliability,
            scan_k=self._scan_k(setup, reader, len(frames), bs),
            stage_only=True)


def _resolve_devices(devices) -> list:
    """The mesh's device list.  None: every visible CUDA device, or
    under several processes the one at ``rank % device_count``; a
    default device that is not CUDA (``device.DEFAULT_DEVICE``) is the
    one shard, as the JAX package's mesh spans its default platform's
    devices.  A repeated entry stands for that many shards on one
    device."""
    if devices is None:
        from mdanalysis_mpi_tpu_torch.parallel.distributed import world

        default = resolve_device(None)          # raises without a card
        if default.type != "cuda":
            return [default]
        n = torch.cuda.device_count()
        rank, size = world()
        if size > 1:
            return [torch.device("cuda", rank % n)]
        return [torch.device("cuda", i) for i in range(n)]
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("MeshExecutor needs at least one device")
    return out


def _split_staged(staged, n: int, planar: bool):
    """One host-staged block → ``n`` per-shard tuples, each a
    contiguous piece along the frame axis (axis 1 of planar ``(3, B, S)``
    planes, axis 0 of everything else: frames, boxes, mask, and the
    delta keyframes and their scales, one anchor a shard).  A scalar
    inverse scale is shared by every shard."""
    pieces = []
    for i, x in enumerate(staged):
        if np.ndim(x) == 0:
            pieces.append([x] * n)
        else:
            axis = 1 if planar and i == 0 else 0
            pieces.append([np.ascontiguousarray(p)
                           for p in np.split(x, n, axis=axis)])
    return [tuple(p[j] for p in pieces) for j in range(n)]


class MeshExecutor:
    """Data-parallel pipeline over several devices (the JAX package's
    ``MeshExecutor``, the image of the reference's SPMD ranks +
    collectives, SURVEY.md §2.3 "DP over frames").

    **Single controller.** ``devices``: a list of devices, by default
    every visible CUDA device; a repeated entry (``["cpu"] * 4``,
    ``["cuda:0"] * 2``) stands for that many shards on one device.  Each
    global batch of ``batch_size × len(devices)`` frames is staged once
    on the host and cut into one contiguous shard per device, in order;
    every device runs the single-device batch function
    (:func:`_batch_setup` — with ``engine='fused'`` and int16/int8/delta
    staging that is the fused kernel's wrapper on each device, the
    CUDA kernel on a CUDA device and its plain version on the CPU), and
    the per-device partials merge through the analysis'
    ``_device_combine`` on the first device, where they fold across
    batches.  Analyses without a combine (time series) come back
    concatenated in frame order.

    **Scan-folded dispatch** (``scan_k``, single controller, frames
    sharded): each device folds its own shard of a cached group — one
    captured CUDA graph a device on the card — and the
    ``_device_combine`` merge runs once per group, not once per block.
    Reductions must declare both a fold and a combine, series neither;
    the ring path and runs under several processes keep the per-block
    schedule.

    **Multi controller.** Under ``torch.distributed`` (see
    :mod:`~mdanalysis_mpi_tpu_torch.parallel.distributed`) every rank
    runs ``execute`` over the same global batch schedule
    (``batch_size × len(devices) × world size`` frames), stages only its
    own slice of each batch, and the partials merge across ranks by
    ``all_reduce`` (reductions) or ``all_gather`` (series) through
    :class:`~mdanalysis_mpi_tpu_torch.parallel.distributed.Collectives`
    over the default process group; ``transport_device`` picks where
    the collectives move tensors (by default the host for a gloo
    group).

    Delta staging keeps one keyframe per device shard.  Atom-sharded
    analyses (``_batch_specs()`` not None: ``InterRDF(engine='ring')``)
    replicate frames and cut the atom axis over the devices and ranks
    instead.  ``prestage`` and ``reliability`` are
    :class:`TorchExecutor`'s.
    """

    name = "mesh"
    # execute() returns one partials tree per call — checkpointable
    per_call_partials = True
    reliability = None

    def __init__(self, batch_size: int = 64, devices=None,
                 block_cache: DeviceBlockCache | None = None,
                 transfer_dtype: str = "float32", prestage: bool = False,
                 reliability=None, scan_k=None, transport_device=None):
        _validate_transfer_dtype(transfer_dtype)
        self.batch_size = batch_size
        self.devices = _resolve_devices(devices)
        self.device = self.devices[0]
        self.block_cache = block_cache
        self.transfer_dtype = transfer_dtype
        self.prestage = prestage
        self.scan_k = scan_k
        self.transport_device = transport_device
        if reliability is not None:
            self.reliability = reliability

    def _comm(self):
        """The process group's :class:`Collectives`, or None when this
        process runs alone."""
        from mdanalysis_mpi_tpu_torch.parallel.distributed import (
            Collectives, world)

        if world()[1] <= 1:
            return None
        return Collectives(self.transport_device)

    def _put(self, split):
        """``split`` (host-staged block → one host tuple a device) then
        each tuple onto its device, the copy on that device's stream of
        the calling thread (the stream its batch function launches on)."""
        devs = self.devices
        streams = [torch.cuda.current_stream(d) if d.type == "cuda"
                   else None for d in devs]

        def put(staged_host):
            out = []
            for shard, dev, stream in zip(split(staged_host), devs,
                                          streams):
                if stream is None:
                    out.append(_put_staged(shard, dev))
                else:
                    with torch.cuda.stream(stream):
                        out.append(_put_staged(shard, dev))
            return tuple(out)

        return put

    def _device_key(self, comm):
        """The block cache key's device part: the shards and this
        rank's slice of every batch."""
        return (tuple(str(d) for d in self.devices),
                None if comm is None else (comm.rank, comm.size))

    def _scan(self, setup, fold, combine, params_dev, comm,
              capture=True):
        """The group dispatch: each device folds its shard (a graph a
        CUDA device unless ``capture`` is False), then one combine
        across devices; a series is reassembled block by block in frame
        order."""
        cache, devs = self.block_cache, self.devices
        dev0 = devs[0]
        fn = setup.fn

        def scan(key, stacked, total):
            role = "series" if fold is None else "local"
            locs = []
            for j, (p, dev) in enumerate(zip(params_dev, devs)):
                shard = stacked[j]

                def body(pp, _tot, shard=shard):
                    return _fold_group(fn, fold, pp, shard, None)

                locs.append(_run_group(
                    cache, key, stacked,
                    setup.program_tag(fold, role, j, p, None), body, p,
                    None, dev, capture))
            if fold is None:
                return _cat_partials([
                    _cat_partials([_tree_to(loc[k], dev0) for loc in locs])
                    for k in range(_group_len(stacked))])
            merged = combine(locs, comm)
            return merged if total is None else fold(total, merged)

        return scan

    def execute(self, analysis, reader, frames, batch_size=None):
        bs = batch_size or self.batch_size
        comm = self._comm()
        combine = analysis._device_combine
        if analysis._batch_specs() is not None:
            return self._execute_ring(analysis, reader, list(frames), bs,
                                      comm)
        fold = analysis._device_fold_fn
        if combine is None and fold is not None:
            raise ValueError(
                f"{type(analysis).__name__} folds its partials but "
                "declares no _device_combine merge for the mesh backend")
        setup = _batch_setup(analysis, self.transfer_dtype)
        fn = setup.fn
        devs = self.devices
        n = len(devs)
        params_dev = [_tree_to(setup.params, d) for d in devs]
        dev0 = devs[0]
        rank, size = (0, 1) if comm is None else (comm.rank, comm.size)
        frames = list(frames)
        gbs = bs * n * size
        scan_k, scan = 1, None
        if comm is None:
            scan_k = self._group_scan_k(analysis, setup, reader,
                                        len(frames), gbs)
            if scan_k > 1:
                scan = self._scan(setup, fold, combine, params_dev, comm,
                                  not getattr(analysis,
                                              "_host_waits_in_batch",
                                              False))

        def call(*shards):
            outs = [fn(p, *s) for p, s in zip(params_dev, shards)]
            if combine is not None:
                return combine(outs, comm)
            out = _cat_partials([_tree_to(o, dev0) for o in outs])
            return out if comm is None else comm.all_gather_tree(out)

        return _run_batches(
            analysis, reader, frames, gbs, call, setup.sel_idx, dev0,
            cache=self.block_cache, quantize=setup.quantize,
            layout=setup.layout, engine=setup.engine,
            put=self._put(lambda staged: _split_staged(
                staged, n, setup.layout == "planar")),
            local_divisor=size, local_index=rank,
            delta_anchors=n if setup.quantize == "delta" else 1,
            device_key=self._device_key(comm),
            reliability=self.reliability, prestage=self.prestage,
            scan_k=scan_k, scan=scan)

    def _local_setup(self, analysis):
        """The frame-sharded single-controller setup ``warmup`` and
        ``stage`` prepare for, or None where they have nothing to do:
        a run under several processes (each rank's staging is its own
        slice of a global schedule), the ring path (atom-sharded
        params) and serial-only analyses."""
        from mdanalysis_mpi_tpu_torch.parallel.distributed import world

        if world()[1] > 1 or analysis._batch_specs() is not None:
            return None
        try:
            return _batch_setup(analysis, self.transfer_dtype)
        except NotImplementedError:
            return None

    def _group_scan_k(self, analysis, setup, reader, n_frames: int,
                      gbs: int) -> int:
        """``execute``'s scan group size on a single controller."""
        if ((analysis._device_fold_fn is None)
                != (analysis._device_combine is None)):
            return 1
        return _resolve_scan_k(
            self.scan_k, self.block_cache, -(-n_frames // gbs),
            _block_nbytes(gbs, setup.sel_idx, reader.n_atoms,
                          self.transfer_dtype))

    def warmup(self, analysis, reader, frames, batch_size=None) -> int:
        """:meth:`TorchExecutor.warmup` on every device of the mesh (the
        JAX package's ``MeshExecutor.warmup``): build and load the
        ``csrc/`` kernel library when a device is a CUDA device, then
        run each device's batch function on its zero shard of the
        exact staged shapes, the ``_device_combine`` merge and the fold
        once, and each scan group length ``execute`` would dispatch on
        every device.  Returns the number of programs run; 0 for a
        serial-only analysis, the ring path and a run under several
        processes."""
        setup = self._local_setup(analysis)
        if setup is None:
            return 0
        bs = batch_size or self.batch_size
        devs = self.devices
        nd = len(devs)
        gbs = bs * nd
        frames = list(frames)
        n_blocks = -(-len(frames) // gbs)
        if n_blocks == 0:
            return 0
        if any(d.type == "cuda" for d in devs):
            from mdanalysis_mpi_tpu_torch import _build

            _build.load()
        n_stage = (reader.n_atoms if setup.sel_idx is None
                   else len(setup.sel_idx))
        anchors = nd if setup.quantize == "delta" else 1
        shards = _split_staged(
            _zero_staged(gbs, n_stage, setup.quantize, setup.layout,
                         delta_anchors=anchors),
            nd, setup.layout == "planar")
        fn, fold = setup.fn, analysis._device_fold_fn
        combine = analysis._device_combine
        params_dev = [_tree_to(setup.params, d) for d in devs]
        staged_dev = [_put_staged(sh, d) for sh, d in zip(shards, devs)]
        n = 0
        outs = []
        for p, st in zip(params_dev, staged_dev):
            outs.append(fn(p, *st))
            _cc.note_warmup()
            n += 1
        if combine is not None:
            merged = combine(outs, None)
            _cc.note_warmup()
            n += 1
            if fold is not None and n_blocks > 1:
                fold(merged, merged)
                _cc.note_warmup()
                n += 1
        init_sizes, fused_sizes = _scan_group_sizes(
            self._group_scan_k(analysis, setup, reader, len(frames), gbs),
            n_blocks)
        for k in sorted(init_sizes | fused_sizes):
            # a mesh group folds each device's shard from no total
            # (the running total folds after the combine)
            for p, st in zip(params_dev, staged_dev):
                _fold_group(fn, fold, p, _stack_staged([st] * k), None)
                _cc.note_warmup()
                n += 1
        return n

    def stage(self, analysis, reader, frames, batch_size=None) -> int:
        """Stage this run's blocks into ``block_cache`` without
        dispatching any kernel (the JAX package's ``MeshExecutor.
        stage``): each device's shard lands on its device under the
        keys and scan grouping ``execute`` reads, so a later run over
        the same window is all hits.  Returns the blocks staged; 0
        without a cache, for a serial-only analysis, the ring path and
        a run under several processes."""
        if self.block_cache is None:
            return 0
        setup = self._local_setup(analysis)
        if setup is None:
            return 0
        bs = batch_size or self.batch_size
        nd = len(self.devices)
        gbs = bs * nd
        frames = list(frames)
        return _run_batches(
            analysis, reader, frames, gbs, None, setup.sel_idx,
            self.devices[0], cache=self.block_cache,
            quantize=setup.quantize, layout=setup.layout,
            engine=setup.engine,
            put=self._put(lambda staged: _split_staged(
                staged, nd, setup.layout == "planar")),
            delta_anchors=nd if setup.quantize == "delta" else 1,
            device_key=self._device_key(None),
            reliability=self.reliability,
            scan_k=self._group_scan_k(analysis, setup, reader,
                                      len(frames), gbs),
            stage_only=True)

    def _execute_ring(self, analysis, reader, frames, bs, comm):
        """Atom-sharded (ring) analyses: frames are replicated (each
        batch of ``bs`` frames goes to every device), the staged union
        atom axis is cut into one contiguous block per device — under
        several processes each rank stages only its ranks' share — and
        the ring batch function rotates the blocks around the devices
        (and across ranks by ``send``/``recv``)."""
        if _quant_mode(self.transfer_dtype) is not None:
            raise ValueError(
                "atom-sharded (ring) kernels support transfer_dtype="
                "'float32' only")
        combine = analysis._device_combine
        if combine is None:
            raise ValueError(
                "atom-sharded kernels need a _device_combine merge")
        params_specs, batch_spec, boxes_spec, mask_spec = \
            analysis._batch_specs()
        devs = self.devices
        n = len(devs)
        rank, size = (0, 1) if comm is None else (comm.rank, comm.size)
        sel = np.asarray(analysis._batch_select())
        if len(sel) % (n * size):
            raise ValueError(
                f"ring union of {len(sel)} atoms does not divide across "
                f"{n * size} devices; use a device count that divides it "
                "(the union is padded to multiples of the ring pad)")
        per = len(sel) // size
        local_sel = sel[rank * per:(rank + 1) * per]

        def cut_local(x, spec, dev_i):
            """Device ``dev_i``'s block of this rank's ``x`` along
            ``spec``, or the whole of ``x``."""
            if spec is None:
                return x
            return np.ascontiguousarray(np.split(x, n, axis=spec)[dev_i])

        def cut(x, spec, dev_i):
            """Device ``dev_i``'s block of the global ``x``: this rank's
            share first."""
            x = np.asarray(x)
            if spec is not None:
                x = np.split(x, size, axis=spec)[rank]
            return cut_local(x, spec, dev_i)

        params = analysis._batch_params()
        params_dev = [tuple(torch.as_tensor(cut(x, s, j), device=d)
                            for x, s in zip(params, params_specs))
                      for j, d in enumerate(devs)]
        specs = (batch_spec, boxes_spec, mask_spec)

        def split(staged_host):
            return [tuple(cut_local(x, s, j)
                          for x, s in zip(staged_host, specs))
                    for j in range(n)]

        fn = analysis._batch_fn()

        def call(*shards):
            outs = fn(params_dev, [s[0] for s in shards],
                      [s[1] for s in shards], [s[2] for s in shards], comm)
            return combine(outs, comm)

        return _run_batches(
            analysis, reader, frames, bs, call, local_sel, devs[0],
            cache=self.block_cache, put=self._put(split),
            device_key=self._device_key(comm),
            reliability=self.reliability, prestage=self.prestage)


from mdanalysis_mpi_tpu_torch.parallel.mpi import MPIExecutor  # noqa: E402
# (importing the module is cheap and mpi4py itself stays lazy — it
# loads only when MPIExecutor() is built without a communicator)

_EXECUTORS = {"serial": SerialExecutor, "torch": TorchExecutor,
              "mesh": MeshExecutor, "mpi": MPIExecutor}


def warmup_analysis(analysis, executor, start=None, stop=None,
                    step=None, frames=None, batch_size=None) -> int:
    """Prepare every program ``analysis.run(backend=executor, ...)``
    would dispatch over this window (the JAX package's
    ``warmup_analysis``): resolve the frame window and run ``_prepare``
    as ``run()`` would, then hand each of the analysis'
    ``_warmup_analyses()`` to the executor's ``warmup``.  Returns the
    programs prepared; 0 for executors with nothing to prepare."""
    if not hasattr(executor, "warmup"):
        return 0
    n = 0
    for a in analysis._warmup_analyses():
        fl = list(a._frames(start, stop, step, frames))
        a.n_frames = len(fl)
        a._frame_indices = fl
        a._run_device = getattr(executor, "device", None)
        a._prepare()
        n += executor.warmup(a, a._universe.trajectory, fl,
                             batch_size=batch_size)
    return n


def stage_analysis(analysis, executor, start=None, stop=None,
                   step=None, frames=None, batch_size=None) -> int:
    """Stage the blocks ``analysis.run(backend=executor, ...)`` would
    stage into the executor's ``block_cache``, without dispatching any
    kernel (the JAX package's ``stage_analysis``).  Returns the blocks
    newly staged."""
    if not hasattr(executor, "stage"):
        return 0
    n = 0
    for a in analysis._warmup_analyses():
        fl = list(a._frames(start, stop, step, frames))
        a.n_frames = len(fl)
        a._frame_indices = fl
        a._run_device = getattr(executor, "device", None)
        a._prepare()
        n += executor.stage(a, a._universe.trajectory, fl,
                            batch_size=batch_size)
    return n


def get_executor(backend, **kwargs):
    """Resolve a backend name or instance → executor instance."""
    if hasattr(backend, "execute"):
        return backend
    try:
        cls = _EXECUTORS[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; available: {sorted(_EXECUTORS)}"
        ) from None
    return cls(**kwargs)
