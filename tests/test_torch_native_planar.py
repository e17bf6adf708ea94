"""The native planar staging pass: gather, int16 quantize and planar
write in one call, its frames split over host threads.  Its planes equal
``planar_repack`` of the interleaved kernels' blocks byte for byte at
any thread count; a ``MemoryReader``'s planar int16 request runs it
(counted as ``path="native_planar"``, no ``repack``), the NumPy fallback
still repacks, and the thread count follows the process's cores and the
ranks on its host.  CPU only; imports no JAX.
"""

import socket
import threading

import numpy as np
import pytest
import torch.distributed as dist

from mdanalysis_mpi_tpu_torch import obs
from mdanalysis_mpi_tpu_torch.io import native
from mdanalysis_mpi_tpu_torch.io.base import planar_repack
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
from mdanalysis_mpi_tpu_torch.parallel import distributed
from mdanalysis_mpi_tpu_torch.staging import quantize_block
from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS

N_ATOMS = 97


def _frames(n_frames, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(scale=20.0, size=(N_ATOMS, 3)).astype(np.float32)
    return base[None] + rng.normal(
        scale=0.5, size=(n_frames, N_ATOMS, 3)).astype(np.float32)


SELECTIONS = {
    "all": None,
    "strided": np.arange(1, N_ATOMS, 3),
    "unsorted_repeats": np.array([40, 3, 3, 96, 0, 57, 40, 12, 12, 5]),
}


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ------------------------------------------------------------ the kernels


@pytest.mark.parametrize("n_frames", [1, 5, 512])
@pytest.mark.parametrize("threads", [1, 2, 3, 7, "more_than_frames"])
@pytest.mark.parametrize("sel", sorted(SELECTIONS))
def test_planar_kernels_equal_repacked_interleaved(n_frames, threads, sel):
    src = _frames(n_frames)
    idx = SELECTIONS[sel]
    nt = n_frames + 3 if threads == "more_than_frames" else threads

    q, inv = native.stage_gather_quantize(src, idx)
    p, inv_p = native.stage_gather_quantize_planar(src, idx, threads=nt)
    _same(p, planar_repack(q))
    _same(np.asarray(inv_p), np.asarray(inv))

    # the one-pass kernel with a scale from a hint above the block max
    hint = float(np.abs(src if idx is None else src[:, idx]).max()) * 1.01
    scale = 32000.0 / (hint * 1.05)
    q, vmax, over = native.stage_gather_quantize_scaled(src, idx, scale)
    p, vmax_p, over_p = native.stage_gather_quantize_scaled_planar(
        src, idx, scale, threads=nt)
    assert not over and not over_p
    assert vmax_p == vmax
    _same(p, planar_repack(q))


@pytest.mark.parametrize("threads", [1, 3, 7])
def test_planar_overflow_verdict_equals_interleaved(threads):
    """A block whose max exceeds the hint: both kernels report the
    overflow with the same true max, and write the same clamped bytes."""
    src = _frames(64)
    src[41, 16] = (900.0, -1200.0, 3.0)      # one selected atom far out
    idx = SELECTIONS["strided"]
    scale = 32000.0 / (30.0 * 1.05)
    q, vmax, over = native.stage_gather_quantize_scaled(src, idx, scale)
    p, vmax_p, over_p = native.stage_gather_quantize_scaled_planar(
        src, idx, scale, threads=threads)
    assert over and over_p
    assert vmax_p == vmax == 1200.0
    _same(p, planar_repack(q))


# -------------------------------------------------------------- the reader


def _stage_pair(blocks, sel):
    """The same frames staged planar and interleaved (then repacked) by
    two readers with the same hint history."""
    src = _frames(48, seed=3)
    src[30:36] *= 1.5           # a later block overflows the hint
    planar, inter = MemoryReader(src), MemoryReader(src)
    out = []
    for a, b in blocks:
        pq, pbox, pinv = planar.stage_block(a, b, sel, "int16",
                                            layout="planar")
        iq, ibox, iinv = inter.stage_block(a, b, sel, "int16")
        out.append((pq, pinv, planar_repack(iq), iinv))
    return out


@pytest.mark.parametrize("sel", sorted(SELECTIONS))
def test_reader_planar_blocks_equal_repacked_interleaved(sel):
    """Consecutive blocks ride the scale hints, the fourth overflows and
    is re-quantized exactly: each planar block equals the interleaved
    block repacked, scale and all."""
    blocks = ((0, 8), (8, 16), (16, 28), (28, 40), (40, 48))
    for pq, pinv, iq, iinv in _stage_pair(blocks, SELECTIONS[sel]):
        _same(pq, iq)
        _same(np.asarray(pinv), np.asarray(iinv))


def _blocks_by_path():
    return obs.METRICS.counter("mdtpu_stage_blocks_total")


def _repacks():
    return obs.METRICS.counter("mdtpu_fused_planar_repacks_total").get("", 0)


def test_planar_int16_engages_the_native_planar_path():
    r = MemoryReader(_frames(32))
    sel = SELECTIONS["strided"]
    before, rep0 = _blocks_by_path(), _repacks()
    acc0, calls0 = TIMERS.snapshot()
    for a in (0, 16):
        q, _, _ = r.stage_block(a, a + 16, sel, "int16", layout="planar")
        assert q.shape == (3, 16, len(sel))
    acc1, calls1 = TIMERS.snapshot()
    after = _blocks_by_path()
    key = 'path="native_planar"'
    assert after.get(key, 0) - before.get(key, 0) == 2
    assert after.get('path="native"', 0) == before.get('path="native"', 0)
    assert _repacks() == rep0
    assert calls1.get("repack", 0) == calls0.get("repack", 0)
    assert calls1.get("gather", 0) - calls0.get("gather", 0) == 2
    threads = obs.METRICS.snapshot()["mdtpu_stage_threads"]["values"][""]
    assert threads == native.stage_threads(16)


def test_int8_and_interleaved_requests_keep_their_paths():
    r = MemoryReader(_frames(16))
    rep0 = _repacks()
    r.stage_block(0, 16, None, "int8", layout="planar")
    assert _repacks() == rep0 + 1
    before = _blocks_by_path()
    r.stage_block(0, 16, None, "int16")
    after = _blocks_by_path()
    assert after.get('path="native"', 0) - before.get('path="native"', 0) == 1


def test_numpy_fallback_repacks_equal_bytes(monkeypatch):
    """A failing native load: the block is staged by NumPy and repacked,
    counted as ``path="numpy"``, with the bytes of the native pass (a
    fresh reader's first block takes the exact scale on both paths)."""
    src = _frames(24)
    sel = SELECTIONS["unsorted_repeats"]
    want, _, want_inv = MemoryReader(src).stage_block(
        0, 24, sel, "int16", layout="planar")

    def broken():
        raise OSError("libtrajio.so: cannot open shared object file")

    monkeypatch.setattr(native, "load", broken)
    before, rep0 = _blocks_by_path(), _repacks()
    got, _, inv = MemoryReader(src).stage_block(0, 24, sel, "int16",
                                                layout="planar")
    after = _blocks_by_path()
    assert after.get('path="numpy"', 0) - before.get('path="numpy"', 0) == 1
    assert after.get('path="native_planar"', 0) == \
        before.get('path="native_planar"', 0)
    assert _repacks() == rep0 + 1
    _same(got, want)
    _same(np.asarray(inv), np.asarray(want_inv))
    ref, ref_inv = quantize_block(src[:, sel], "int16", layout="planar")
    _same(got, ref)
    _same(np.asarray(inv), np.asarray(ref_inv))


# ------------------------------------------------------- the thread count


@pytest.mark.parametrize("cores, ranks, n_frames, want", [
    (1, 1, 512, 1),         # one core: today's serial loop
    (2, 1, 512, 1),
    (8, 1, 512, 7),         # one rank a host: all cores but one
    (32, 4, 512, 7),        # four ranks on one host share its cores
    (32, 1, 512, 31),
    (8, 4, 512, 1),         # more ranks than cores can feed
    (8, 1, 3, 3),           # never more threads than frames
    (8, 1, 0, 1),
])
def test_stage_threads_rule(cores, ranks, n_frames, want):
    assert native.stage_threads(n_frames, cores=cores, ranks=ranks) == want


def test_concurrent_readers_stage_the_lone_bytes(monkeypatch):
    """Three threads stage planar blocks from their own readers at once,
    as a Scheduler's two workers and its prefetch thread fill caches:
    each pass takes the process's whole count, and each block equals
    the one a lone pass stages."""
    monkeypatch.setattr(native.os, "sched_getaffinity",
                        lambda pid: set(range(8)), raising=False)
    monkeypatch.setattr(distributed, "ranks_on_host", lambda: 1)
    seen = []

    def recording(kernel):
        def run(*args, threads=None):
            seen.append(threads)
            return kernel(*args, threads=threads)
        return run

    sel = SELECTIONS["strided"]
    srcs = [_frames(64, seed) for seed in (31, 32, 33)]

    def blocks(reader):
        return [reader.stage_block(a, a + 8, sel, "int16",
                                   layout="planar")[0]
                for a in range(0, 64, 8)]

    want = [blocks(MemoryReader(src)) for src in srcs]
    for name in ("stage_gather_quantize_planar",
                 "stage_gather_quantize_scaled_planar"):
        monkeypatch.setattr(native, name, recording(getattr(native, name)))
    got = [None] * len(srcs)
    start = threading.Barrier(len(srcs))

    def fill(i):
        r = MemoryReader(srcs[i])
        start.wait()
        got[i] = blocks(r)

    workers = [threading.Thread(target=fill, args=(i,))
               for i in range(len(srcs))]
    for t in workers:
        t.start()
    for t in workers:
        t.join()
    assert seen == [7] * (3 * 8)
    for g, w in zip(got, want):
        for gq, wq in zip(g, w):
            _same(gq, wq)


def test_stage_threads_reads_affinity_and_ranks(monkeypatch):
    monkeypatch.setattr(native.os, "sched_getaffinity", lambda pid: {0},
                        raising=False)
    assert native.stage_threads(512) == 1
    monkeypatch.setattr(native.os, "sched_getaffinity",
                        lambda pid: set(range(32)), raising=False)
    monkeypatch.setattr(distributed, "ranks_on_host", lambda: 4)
    assert native.stage_threads(512) == 7
    monkeypatch.setattr(distributed, "ranks_on_host", lambda: 1)
    assert native.stage_threads(512) == 31


def test_ranks_on_host_without_a_group_is_one():
    assert not dist.is_initialized()
    assert distributed.ranks_on_host() == 1


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_ranks_on_host_counts_loopback_and_host_names():
    """Ranks that meet at a loopback address all share this host; at
    any other address the host names are gathered over the group."""
    assert distributed._count_ranks_on_host("localhost:1234", 4) == 4
    assert distributed._count_ranks_on_host("127.0.0.1:1234", 3) == 3
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
        world_size=1, rank=0)
    try:
        assert distributed._count_ranks_on_host("10.1.2.3:29500", 1) == 1
        assert distributed._count_ranks_on_host(None, 1) == 1
    finally:
        dist.destroy_process_group()
