"""AlignedRMSF read straight from an XTC file, as RMSF.py reads
``mda.Universe(GRO, XTC)``: the answer against a plain float64
reference on the XTC-rounded frames, the ``decode`` phase inside
``gather``, the XTC staging counters, and the reader's staged int16
bytes against the base read-then-quantize path.  CPU only; imports no
JAX.
"""

import os

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch import obs
from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io import native
from mdanalysis_mpi_tpu_torch.io.base import ReaderBase, planar_repack
from mdanalysis_mpi_tpu_torch.io.xtc import XTCReader, write_xtc
from mdanalysis_mpi_tpu_torch.obs import spans
from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS

N_ATOMS, N_FRAMES, BATCH = 2000, 300, 64
N_BLOCKS = -(-N_FRAMES // BATCH)
#: a planar block's frames, which none of the thread counts below divide
#: evenly
BLOCK = 37
NAMES = np.array(["CA", "CB", "HA", "HB"])
#: the heavy atoms: CA and CB of every residue
HEAVY = np.flatnonzero(np.isin(np.tile(NAMES, N_ATOMS // 4), ["CA", "CB"]))


def _topology():
    return Topology(names=np.tile(NAMES, N_ATOMS // 4),
                    resnames=np.full(N_ATOMS, "ALA"),
                    resids=np.arange(N_ATOMS) // 4 + 1)


def _frames(seed=0, n_frames=N_FRAMES):
    """A chain of bonded steps (a walk of 1.5 Å steps along random
    axes), each frame rotated about z by 0.1 rad sigma plus 0.3 Å of
    noise."""
    r = np.random.default_rng(seed)
    steps = np.eye(3)[r.integers(0, 3, N_ATOMS)] * r.choice([-1.5, 1.5],
                                                            (N_ATOMS, 1))
    base = np.cumsum(steps, axis=0)
    base -= base.mean(0)
    a = r.normal(scale=0.1, size=n_frames)
    c, s = np.cos(a)[:, None], np.sin(a)[:, None]
    out = r.normal(scale=0.3, size=(n_frames, N_ATOMS, 3))
    out[..., 0] += base[:, 0] * c + base[:, 1] * s
    out[..., 1] += base[:, 1] * c - base[:, 0] * s
    out[..., 2] += base[:, 2]
    return out.astype(np.float32)


@pytest.fixture(scope="module")
def xtc_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("xtc_rmsf") / "traj.xtc")
    write_xtc(path, _frames(), precision=1000.0)
    return path


@pytest.fixture(scope="module")
def growing_xtc(tmp_path_factory):
    """Two blocks of ``BLOCK`` frames in a box, the second at twice the
    first's extent: the scale hint the first seeds overflows on the
    second."""
    frames = _frames(seed=2, n_frames=2 * BLOCK)
    frames[BLOCK:] *= 2.0
    path = str(tmp_path_factory.mktemp("xtc_grow") / "grow.xtc")
    write_xtc(path, frames, dimensions=np.array([150.0, 150, 150, 90, 90,
                                                 90]), precision=1000.0)
    return path


@pytest.fixture
def no_tracing():
    spans.disable(discard=True)
    yield
    spans.disable(discard=True)


def _reference(frames):
    """Plain float64 AlignedRMSF of the heavy atoms: superpose every
    frame onto frame 0 (centroid, then the Kabsch rotation by an SVD),
    average; superpose every frame onto the average, and take each
    atom's root mean square fluctuation about its mean."""
    x = frames[:, HEAVY].astype(np.float64)
    x = x - x.mean(axis=1, keepdims=True)

    def aligned(ref):
        u, _, vh = np.linalg.svd(np.einsum("fsi,sj->fij", x, ref))
        d = np.sign(np.linalg.det(u @ vh))
        u[:, :, 2] *= d[:, None]
        return np.einsum("fsi,fij->fsj", x, u @ vh)

    ref0 = frames[0, HEAVY].astype(np.float64)
    com = ref0.mean(0)
    avg = aligned(ref0 - com).mean(0) + com
    dev = aligned(avg - avg.mean(0)) + avg.mean(0) - avg
    rmsf = np.sqrt((dev ** 2).mean(0).sum(1) - (dev.mean(0) ** 2).sum(1))
    return avg, rmsf


def _run(path):
    a = AlignedRMSF(Universe(_topology(), path), select="heavy",
                    engine="fused").run(backend="torch", device="cpu",
                                        batch_size=BATCH,
                                        transfer_dtype="int16")
    return a


def test_answer_agrees_with_a_float64_reference_on_the_xtc_frames(
        xtc_path, no_tracing):
    """The reference reads the frames the XTC holds (rounded to 0.01 Å
    at precision 1000); the int16 wire's step at this globule's extent
    (max |x| about 40 Å) is 40 × 1.05 / 32,000 ≈ 1.3e-3 Å, and its
    rounding averages down over the frames: the gaps read 1.4e-4 Å,
    and on the int8 wire 2.2e-2 (average) and 4.4e-2 (RMSF), so 1e-3 Å
    lies between them."""
    rounded, _ = XTCReader(xtc_path).read_block(0, N_FRAMES)
    assert np.abs(rounded - _frames()).max() <= 0.005 + 1e-4
    avg, rmsf = _reference(rounded)
    a = _run(xtc_path)
    got_avg = np.asarray(a.results["average"], np.float64)
    got_rmsf = np.asarray(a.results["rmsf"], np.float64)
    assert got_avg.shape == avg.shape and got_rmsf.shape == rmsf.shape
    assert np.abs(got_avg - avg).max() < 1e-3
    assert np.abs(got_rmsf - rmsf).max() < 1e-3


def test_decode_nests_in_gather_and_counts_the_file(xtc_path, no_tracing):
    """Pass 1 stages every block through one native decode each (the
    first block's float32 seed read, quantized to planes by the exact
    native planar kernel, then the fused planar int16 decode), each in
    ``decode`` inside ``gather``; the decoded bytes are the whole file's
    frames, and no block is decoded twice."""
    acc0, calls0 = TIMERS.snapshot()
    rep = _run(xtc_path).results.observability
    acc1, calls1 = TIMERS.snapshot()

    def d(name):
        return acc1.get(name, 0.0) - acc0.get(name, 0.0)

    assert rep["phases"]["decode"]["calls"] == N_BLOCKS
    assert rep["phases"]["gather"]["calls"] == N_BLOCKS
    assert 0 < d("decode") <= d("gather")
    assert rep["staging"]["blocks"] == {"native_planar": 1,
                                        "xtc_planar": N_BLOCKS - 1}
    assert rep["staging"]["xtc_decoded_bytes"] == os.path.getsize(xtc_path)
    assert "xtc_redecodes" not in rep["staging"]


def test_an_overflowing_block_counts_one_redecode(tmp_path, no_tracing):
    """A block whose coordinates outgrow the scale hint (the second
    block twice the first's extent) is decoded again at an exact scale:
    one re-decode, its bytes counted twice, two ``decode`` phases, and
    the staged block still within a step of the frames."""
    frames = _frames(seed=1, n_frames=2 * BATCH)
    frames[BATCH:] *= 2.0
    path = str(tmp_path / "grow.xtc")
    write_xtc(path, frames, precision=1000.0)
    r = XTCReader(path)
    r.stage_block(0, BATCH, sel=HEAVY, quantize="int16")

    def counts():
        return (sum(obs.METRICS.counter("mdtpu_xtc_redecodes_total")
                    .values()),
                sum(obs.METRICS.counter("mdtpu_xtc_decoded_bytes_total")
                    .values()),
                TIMERS.calls("decode"))

    before = counts()
    q, _, inv_scale = r.stage_block(BATCH, 2 * BATCH, sel=HEAVY,
                                    quantize="int16")
    after = counts()
    span = os.path.getsize(path) - int(r._offsets[BATCH])
    assert after[0] - before[0] == 1
    assert after[1] - before[1] == 2 * span
    assert after[2] - before[2] == 2
    decoded, _ = r.read_block(BATCH, 2 * BATCH, sel=HEAVY)
    assert np.abs(q * inv_scale - decoded).max() <= inv_scale


@pytest.mark.parametrize("layout", ["interleaved", "planar"])
def test_staged_bytes_equal_the_base_read_then_quantize(xtc_path, layout):
    """The reader's fused decode and quantize stages, block after block,
    the bytes and scales of ``ReaderBase.stage_block`` (its float32 read,
    then the quantize) on a reader of the same file."""
    fused, base = XTCReader(xtc_path), XTCReader(xtc_path)
    for lo in range(0, N_FRAMES, BATCH):
        hi = min(lo + BATCH, N_FRAMES)
        q, boxes, inv = fused.stage_block(lo, hi, sel=HEAVY,
                                          quantize="int16", layout=layout)
        bq, bboxes, binv = ReaderBase.stage_block(
            base, lo, hi, sel=HEAVY, quantize="int16", layout=layout)
        assert q.dtype == bq.dtype == np.int16 and q.shape == bq.shape
        assert q.tobytes() == bq.tobytes()
        assert np.float32(inv).tobytes() == np.float32(binv).tobytes()
        assert boxes is None and bboxes is None


#: each case's file and the blocks a fresh reader stages, the last one
#: compared: a fresh reader's seed block, a hinted block, and a hinted
#: block that overflows its hint
PLANAR_CASES = {
    "seed": ("xtc_path", [(0, BLOCK)]),
    "hinted": ("xtc_path", [(0, BLOCK), (BLOCK, 2 * BLOCK)]),
    "overflow": ("growing_xtc", [(0, BLOCK), (BLOCK, 2 * BLOCK)]),
}


def _redecodes():
    return sum(obs.METRICS.counter("mdtpu_xtc_redecodes_total").values())


@pytest.mark.parametrize("threads", [1, 3, 2 * BLOCK])
@pytest.mark.parametrize("case", sorted(PLANAR_CASES))
def test_planar_block_equals_the_repacked_single_thread_block(
        case, threads, request, monkeypatch):
    """The planar block, decoded over 1, 3 or more threads than it has
    frames, is ``planar_repack`` of the interleaved block staged on one
    decode thread, with the same inverse scale and boxes; the
    overflowing block is decoded again exactly once."""
    name, blocks = PLANAR_CASES[case]
    path = request.getfixturevalue(name)
    monkeypatch.delenv("MDTPU_DECODE_THREADS", raising=False)
    ref = XTCReader(path)
    for lo, hi in blocks:
        rq, rboxes, rinv = ref.stage_block(lo, hi, sel=HEAVY,
                                           quantize="int16")
    monkeypatch.setattr(native, "stage_threads", lambda n, *a, **k: threads)
    r = XTCReader(path)
    for lo, hi in blocks[:-1]:
        r.stage_block(lo, hi, sel=HEAVY, quantize="int16", layout="planar")
    before = _redecodes()
    q, boxes, inv = r.stage_block(*blocks[-1], sel=HEAVY, quantize="int16",
                                  layout="planar")
    assert _redecodes() - before == (case == "overflow")
    assert q.dtype == np.int16 and q.shape == (3, BLOCK, len(HEAVY))
    assert q.tobytes() == planar_repack(rq).tobytes()
    assert np.float32(inv).tobytes() == np.float32(rinv).tobytes()
    assert (boxes is None) == (rboxes is None) == (name == "xtc_path")
    if boxes is not None:
        np.testing.assert_array_equal(boxes, rboxes)


def test_a_planar_block_counts_its_path_threads_and_decoded_bytes(
        xtc_path, no_tracing, monkeypatch):
    """A fresh reader's planar seed block counts as ``native_planar``
    (its planes come from the exact native planar kernel); a hinted
    planar block counts as ``xtc_planar``, sets ``mdtpu_stage_threads``
    to its thread count, runs one ``decode`` span inside its ``gather``
    span, counts its compressed bytes once, and repacks nothing."""
    monkeypatch.setattr(native, "stage_threads", lambda n, *a, **k: 3)

    def counts():
        return (obs.METRICS.counter("mdtpu_stage_blocks_total"),
                sum(obs.METRICS.counter("mdtpu_xtc_decoded_bytes_total")
                    .values()),
                sum(obs.METRICS.counter("mdtpu_fused_planar_repacks_total")
                    .values()))

    def blocks_delta(before, after):
        return {k: n - before.get(k, 0) for k, n in after.items()
                if n != before.get(k, 0)}

    r = XTCReader(xtc_path)
    c0 = counts()
    r.stage_block(0, BLOCK, sel=HEAVY, quantize="int16", layout="planar")
    c1 = counts()
    assert blocks_delta(c0[0], c1[0]) == {'path="native_planar"': 1}
    spans.enable()
    r.stage_block(BLOCK, 2 * BLOCK, sel=HEAVY, quantize="int16",
                  layout="planar")
    doc = spans.document()
    c2 = counts()
    assert blocks_delta(c1[0], c2[0]) == {'path="xtc_planar"': 1}
    gauge = obs.METRICS.snapshot()["mdtpu_stage_threads"]["values"][""]
    assert gauge == 3
    span = int(r._offsets[2 * BLOCK] - r._offsets[BLOCK])
    assert c1[1] - c0[1] == int(r._offsets[BLOCK] - r._offsets[0])
    assert c2[1] - c1[1] == span
    assert c2[2] == c0[2]
    done = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    (g,) = [e for e in done if e["name"] == "gather"]
    (d,) = [e for e in done if e["name"] == "decode"]
    assert d["tid"] == g["tid"]
    assert g["ts"] <= d["ts"]
    assert d["ts"] + d["dur"] <= g["ts"] + g["dur"]
