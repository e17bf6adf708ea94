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

Not ported yet (later slices): scan-folded dispatch (ROADMAP A4), the
prestage cold pipeline, AOT warmup and the compile cache, integrity
fingerprints and scrubbing, reliability (A9).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.device import resolve_device
from mdanalysis_mpi_tpu_torch.io.base import BlockCache, sel_fingerprint
from mdanalysis_mpi_tpu_torch.parallel.partition import (iter_batches,
                                                         pad_batch)
from mdanalysis_mpi_tpu_torch.staging import (quantize_block,
                                              quantize_block_delta)


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


class DeviceBlockCache(BlockCache):
    """Device-resident staged-block cache shared across trajectory
    passes: AlignedRMSF's pass 2 reads the blocks pass 1 staged instead
    of re-staging them (the reference re-decodes every frame in pass 2,
    RMSF.py:124).  A byte-capped dict of device tensors (insert until
    ``max_bytes``, then stop; blocks beyond the cap are re-staged).  The
    cache holds the only reference to its tensors, so an overwritten
    entry goes back to PyTorch's allocator when it is replaced, and
    :meth:`clear` releases every entry."""

    def __init__(self, max_bytes: int = 4 << 30):
        super().__init__(max_bytes)


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


def _run_batches(analysis, reader, frames, bs, call, sel_idx, device,
                 cache: "DeviceBlockCache | None" = None, quantize=None,
                 layout: str = "interleaved", engine: str = "generic",
                 put=None, local_divisor: int = 1, local_index: int = 0,
                 delta_anchors: int = 1, device_key=None):
    """Shared batch loop: stage on the host → copy to the device → run
    the batch function → fold the partials on the device.

    The host staging of block i+1 runs on a helper thread while block i
    is consumed.  Partials never leave the device: results are folded
    with the analysis' ``_device_fold_fn`` (reductions) or concatenated
    along the frame axis at the end (per-frame series).  With
    ``engine='fused'`` every consumed block is counted in
    ``mdtpu_fused_blocks_total``.

    The mesh executor passes ``put`` (host-staged tuple → what ``call``
    takes, by default the tuple's tensors on ``device`` on the caller's
    stream) and ``device_key`` (the cache key's device part: its device
    list and this rank's place, which fix the shards, the rank's slice
    and the delta anchors).  Under
    several processes (``local_divisor`` = the world size) batch bounds
    stay GLOBAL — every rank walks the same batch schedule, so their
    collectives pair up — and each rank stages only its
    ``local_index``-th ``1/local_divisor`` slice of every batch, padded
    to that size.  Delta staging cuts each staged block into
    ``delta_anchors`` segments, one keyframe each."""
    from mdanalysis_mpi_tpu_torch import obs

    fold = analysis._device_fold_fn
    total = None
    parts = []
    bounds = list(iter_batches(0, len(frames), bs))
    sel_fp = sel_fingerprint(sel_idx)
    reader_fp = reader_fingerprint(reader)
    xform_fp = getattr(reader, "transformations", ())
    planar = layout == "planar"
    # the helper thread issues the copies on the caller's stream, the
    # one ``call`` launches on, so a kernel never reads a block before
    # its copy lands
    stream = (torch.cuda.current_stream(device) if device.type == "cuda"
              else None)

    if device_key is None:
        device_key = str(device)
    if put is None:
        def put(staged_host):
            if stream is None:
                return _put_staged(staged_host, device)
            with torch.cuda.stream(stream):
                return _put_staged(staged_host, device)

    def _key(a, b):
        # a shared cache must never serve blocks staged for another
        # selection, trajectory, batch size, wire format, layout or device
        return (reader_fp, tuple(frames[a:b]), bs, quantize, sel_fp,
                xform_fp, device_key) + (("planar",) if planar else ())

    def _host_stage(batch_frames):
        """Host side of one block: read + gather (+ quantize) + pad.
        Returns (staged host tuple, resident nbytes)."""
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
        staged_planar = False
        if contiguous and stage is not None:
            if planar and q_inline:
                block, boxes, inv_scale = stage(
                    batch_frames[0], batch_frames[-1] + 1, sel_idx,
                    q_inline, layout="planar")
                staged_planar = True
            else:
                block, boxes, inv_scale = stage(
                    batch_frames[0], batch_frames[-1] + 1, sel_idx,
                    q_inline)
        else:
            block, boxes = _stage(reader, batch_frames, sel_idx)
            inv_scale = None
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
                padded, delta_anchors, n_valid=block.shape[0])
            return ((res, dkey, inv_abs, inv_res, boxes_p, mask),
                    res.nbytes + dkey.nbytes)
        if quantize:
            return (padded, inv_scale, boxes_p, mask), padded.nbytes
        return (padded, boxes_p, mask), padded.nbytes

    def prepare(bi):
        a, b = bounds[bi]
        key = _key(a, b)
        if cache is not None:
            staged = cache.get(key)
            if staged is not None:
                return staged
        staged_host, nbytes = _host_stage(frames[a:b])
        staged = put(staged_host)
        if cache is not None:
            cache.put(key, staged, nbytes)
        return staged

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(prepare, 0) if bounds else None
        for bi in range(len(bounds)):
            staged = fut.result()
            if bi + 1 < len(bounds):
                fut = pool.submit(prepare, bi + 1)
            out = call(*staged)
            if engine == "fused":
                obs.METRICS.inc("mdtpu_fused_blocks_total")
            if fold is None:
                parts.append(out)
            else:
                total = out if total is None else fold(total, out)
    if fold is not None:
        return total if total is not None else analysis._identity_partials()
    if not parts:
        return analysis._identity_partials()
    return _cat_partials(parts)


class SerialExecutor:
    """Frame-at-a-time host loop (the reference's per-rank body,
    RMSF.py:91-103/123-138, minus MPI)."""

    name = "serial"
    # execute() accumulates inside the analysis and returns the full
    # summary, not per-call partials
    per_call_partials = False

    def execute(self, analysis, reader, frames, batch_size=None):
        for i in frames:
            analysis._single_frame(reader[i])
        return analysis._serial_summary()


def _batch_setup(analysis, transfer_dtype: str):
    """Batch function, params, staged selection, quantize mode, staging
    layout and engine label of one run: the fused quantized-native
    function when the analysis registers one (its ``staging_layout``
    says whether the blocks stage as planar ``(3, B, S)`` planes;
    engine ``'fused'``), else the analysis' batch function behind the
    dequant or delta wrapper (engine ``'generic'``).  The single-device
    and the mesh executors share it, so a mesh device runs exactly the
    function a single device runs."""
    quantize = _quant_mode(transfer_dtype)
    qn = _quantized_native(analysis, transfer_dtype)
    if qn is not None:
        fn, params, sel_idx = qn
        return (fn, params, sel_idx, quantize,
                getattr(fn, "staging_layout", "interleaved"), "fused")
    base_fn = analysis._batch_fn()
    params = analysis._batch_params()
    if transfer_dtype == "delta":
        fn, params = _delta_wrapper(base_fn), (None, params)
    elif quantize:
        fn, params = _dequant_wrapper(base_fn), (None, params)
    else:
        fn = base_fn
    return (fn, params, analysis._batch_select(), quantize,
            "interleaved", "generic")


class TorchExecutor:
    """Single-device batch pipeline: stage block → batch function →
    on-device float32 fold across blocks.

    ``device``: ``None`` (the default device, ``cuda``, which must be
    present), ``"cuda"``, ``"cuda:N"`` or ``"cpu"``.  ``transfer_dtype``
    picks the wire format (``float32``, ``int16``, ``int8``,
    ``delta``).  ``block_cache``: a :class:`DeviceBlockCache` shared
    across passes, or None."""

    name = "torch"
    per_call_partials = True

    def __init__(self, batch_size: int = 128, device=None,
                 block_cache: DeviceBlockCache | None = None,
                 transfer_dtype: str = "float32"):
        _validate_transfer_dtype(transfer_dtype)
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.block_cache = block_cache
        self.transfer_dtype = transfer_dtype

    def execute(self, analysis, reader, frames, batch_size=None):
        if getattr(analysis, "_mesh_only", False):
            raise ValueError(
                f"{type(analysis).__name__} uses an atom-sharded ring "
                "kernel (collectives across devices); run it with "
                "backend='mesh'")
        bs = batch_size or self.batch_size
        fn, params, sel_idx, quantize, layout, engine = _batch_setup(
            analysis, self.transfer_dtype)
        params = _tree_to(params, self.device)
        return _run_batches(
            analysis, reader, list(frames), bs,
            lambda *staged: fn(params, *staged), sel_idx, self.device,
            cache=self.block_cache, quantize=quantize, layout=layout,
            engine=engine)


def _resolve_devices(devices) -> list:
    """The mesh's device list.  None: every visible CUDA device, or
    under several processes the one at ``rank % device_count``; a
    repeated entry stands for that many shards on one device."""
    if devices is None:
        from mdanalysis_mpi_tpu_torch.parallel.distributed import world

        resolve_device(None)          # raises without a card
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
    instead.  Scan-folded dispatch (``scan_k`` other than None/1,
    ROADMAP A4), ``prestage`` and ``reliability`` (A9) are not ported.
    """

    name = "mesh"
    per_call_partials = True

    def __init__(self, batch_size: int = 64, devices=None,
                 block_cache: DeviceBlockCache | None = None,
                 transfer_dtype: str = "float32", prestage: bool = False,
                 reliability=None, scan_k=None, transport_device=None):
        _validate_transfer_dtype(transfer_dtype)
        if scan_k not in (None, 1):
            raise NotImplementedError(
                "MeshExecutor(scan_k=...): scan-folded dispatch is not "
                "ported yet (ROADMAP A4)")
        if prestage:
            raise NotImplementedError(
                "MeshExecutor(prestage=True): the prestage cold pipeline "
                "is not ported yet (ROADMAP A9)")
        if reliability is not None:
            raise NotImplementedError(
                "MeshExecutor(reliability=...): fault-tolerant execution "
                "is not ported yet (ROADMAP A9)")
        self.batch_size = batch_size
        self.devices = _resolve_devices(devices)
        self.device = self.devices[0]
        self.block_cache = block_cache
        self.transfer_dtype = transfer_dtype
        self.transport_device = transport_device

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

    def execute(self, analysis, reader, frames, batch_size=None):
        bs = batch_size or self.batch_size
        comm = self._comm()
        combine = analysis._device_combine
        if analysis._batch_specs() is not None:
            return self._execute_ring(analysis, reader, list(frames), bs,
                                      comm)
        if combine is None and analysis._device_fold_fn is not None:
            raise ValueError(
                f"{type(analysis).__name__} folds its partials but "
                "declares no _device_combine merge for the mesh backend")
        fn, params, sel_idx, quantize, layout, engine = _batch_setup(
            analysis, self.transfer_dtype)
        devs = self.devices
        n = len(devs)
        params_dev = [_tree_to(params, d) for d in devs]
        dev0 = devs[0]
        rank, size = (0, 1) if comm is None else (comm.rank, comm.size)

        def call(*shards):
            outs = [fn(p, *s) for p, s in zip(params_dev, shards)]
            if combine is not None:
                return combine(outs, comm)
            out = _cat_partials([_tree_to(o, dev0) for o in outs])
            return out if comm is None else comm.all_gather_tree(out)

        return _run_batches(
            analysis, reader, list(frames), bs * n * size, call, sel_idx,
            dev0, cache=self.block_cache, quantize=quantize, layout=layout,
            engine=engine,
            put=self._put(lambda staged: _split_staged(
                staged, n, layout == "planar")),
            local_divisor=size, local_index=rank,
            delta_anchors=n if quantize == "delta" else 1,
            device_key=self._device_key(comm))

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
            device_key=self._device_key(comm))


from mdanalysis_mpi_tpu_torch.parallel.mpi import MPIExecutor  # noqa: E402
# (importing the module is cheap and mpi4py itself stays lazy — it
# loads only when MPIExecutor() is built without a communicator)

_EXECUTORS = {"serial": SerialExecutor, "torch": TorchExecutor,
              "mesh": MeshExecutor, "mpi": MPIExecutor}


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
