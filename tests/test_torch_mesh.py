"""The port's ``MeshExecutor`` over four CPU shards against the JAX
package's ``MeshExecutor`` over four virtual CPU devices
(tests/conftest.py gives the JAX package eight).

Both packages build their universes with their own ``testing``
fixtures (the same code, so the same coordinates; checked below).  The
port's mesh cuts every global batch of ``batch_size × 4`` frames into
four contiguous shards, runs the single-device batch function on each
and merges the partials with the analysis' ``_device_combine``.

Tolerances are the JAX package's own mesh tests':
tests/test_analysis.py (AverageStructure atol 2e-4, AlignedRMSF rtol
5e-3 atol 1e-4, RMSD rtol 1e-3 atol 2e-4 against the serial oracle),
tests/test_pallas_rmsf.py (fused int16 within 1e-3 of the oracle, fused
vs generic 5e-4), tests/test_delta_staging.py (delta within 1e-3 of the
oracle on the correlated fixture, fused vs generic 5e-3),
tests/test_distances.py (InterRDF counts within 3 of the oracle,
ContactMap within 0.01) and tests/test_rdf_s.py (InterRDF_s counts
within 1e-6).  Against the JAX package's mesh, whose planar fused form
is demoted to its generic form there (``mdtpu_fused_fallbacks_total``),
the port's fused route is held at the fused-vs-generic tolerance: 5e-4
Å (delta 5e-3 Å).  The port demotes nothing: the fused kernel's plain
version runs on every shard and the fallback counter stays 0.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

torch.set_num_threads(1)

from mdanalysis_mpi_tpu import analysis as jax_analysis  # noqa: E402
from mdanalysis_mpi_tpu import testing as jax_testing  # noqa: E402
from mdanalysis_mpi_tpu.ops import moments as jax_moments  # noqa: E402
from mdanalysis_mpi_tpu.parallel.executors import (  # noqa: E402
    MeshExecutor as JaxMesh)

from mdanalysis_mpi_tpu_torch import analysis, obs, testing  # noqa: E402
from mdanalysis_mpi_tpu_torch.analysis.base import (  # noqa: E402
    AnalysisBase, tree_add, tree_psum)
from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp  # noqa: E402
from mdanalysis_mpi_tpu_torch.ops import moments  # noqa: E402
from mdanalysis_mpi_tpu_torch.parallel import executors  # noqa: E402
from mdanalysis_mpi_tpu_torch.parallel.executors import (  # noqa: E402
    MeshExecutor, get_executor)
from mdanalysis_mpi_tpu_torch.staging import quantize_block_delta  # noqa: E402

N_SHARDS = 4
CPU4 = ["cpu"] * N_SHARDS
SEL = "protein and name CA"


def _jdevs():
    devs = jax.devices()[:N_SHARDS]
    assert len(devs) == N_SHARDS, "tests/conftest.py gives 8 CPU devices"
    return devs


def _port_mesh(**kw):
    return MeshExecutor(batch_size=kw.pop("batch_size", 4), devices=CPU4,
                        **kw)


def _jax_mesh(**kw):
    return JaxMesh(batch_size=kw.pop("batch_size", 4), devices=_jdevs(),
                   **kw)


@pytest.fixture(scope="module")
def pair():
    """(port universe, JAX universe) of the same protein fixture."""
    kw = dict(n_residues=12, n_frames=30, noise=0.25, seed=3)
    up = testing.make_protein_universe(**kw)
    uj = jax_testing.make_protein_universe(**kw)
    np.testing.assert_array_equal(up.trajectory.read_block(0, 30)[0],
                                  uj.trajectory.read_block(0, 30)[0])
    return up, uj


@pytest.fixture(scope="module")
def md_pair():
    """The correlated fixture the delta wire needs (frame-to-frame
    steps are its precision)."""
    kw = dict(n_residues=40, n_frames=64, step=0.05, seed=2)
    return (testing.make_md_universe(**kw),
            jax_testing.make_md_universe(**kw))


def _count(name):
    """A counter's total over its labels (0 before it is first hit)."""
    snap = obs.METRICS.snapshot().get(name, {})
    return sum(snap.get("values", {}).values())


def _fallbacks():
    return _count("mdtpu_fused_fallbacks_total")


def _fused_blocks():
    return _count("mdtpu_fused_blocks_total")


# ---------------------------------------------------------------- merges

@pytest.mark.parametrize("k", [1, 2, 4, 5])
def test_psum_moments_matches_reduce_moments(k):
    """Law of total variance over k shards == the Chan fold, in both
    packages' forms, an empty shard included."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(4 * k + 3, 7, 3)).astype(np.float32)
    cuts = np.sort(rng.choice(np.arange(1, len(x)), k - 1, replace=False))
    blocks = np.split(x, cuts) + [x[:0]]
    parts = [moments.batch_moments(torch.from_numpy(b)) for b in blocks]
    got = moments.psum_moments(parts)
    want = moments.reduce_moments(parts)
    whole = moments.batch_moments(torch.from_numpy(x))
    for g, w, a in zip(got, want, whole):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5)
    jparts = [tuple(np.asarray(v, np.float64) for v in p) for p in parts]
    jwant = jax_moments.reduce_moments(jparts)
    for g, w in zip(got, jwant):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


def test_tree_psum_sums_leaves_on_the_first_device():
    parts = [(torch.tensor(float(i)), torch.full((3,), float(i)))
             for i in range(4)]
    t, v = tree_psum(parts)
    assert float(t) == 6.0 and v.tolist() == [6.0] * 3


# ------------------------------------------------------------- AlignedRMSF

_JAX_RMSF = {}


def _jax_rmsf(uj, td):
    """The JAX package's 4-device mesh AlignedRMSF (its generic route)
    per wire format, computed once."""
    if td not in _JAX_RMSF:
        _JAX_RMSF[td] = np.asarray(jax_analysis.AlignedRMSF(
            uj, select=SEL if td != "delta" else "name CA").run(
            backend=_jax_mesh(transfer_dtype=td)).results.rmsf)
    return _JAX_RMSF[td]


@pytest.mark.parametrize("engine", [None, "fused"])
@pytest.mark.parametrize("td", ["float32", "int16", "int8", "delta"])
def test_aligned_rmsf_mesh_matches_jax_mesh(pair, md_pair, td, engine,
                                            monkeypatch):
    up, uj = md_pair if td == "delta" else pair
    sel = "name CA" if td == "delta" else SEL
    calls = []
    plain = fp.planar_sums_plain

    def counted(*a, **k):
        calls.append(a[0].shape)
        return plain(*a, **k)

    monkeypatch.setattr(fp, "planar_sums_plain", counted)
    fallbacks0, blocks0 = _fallbacks(), _fused_blocks()
    r = analysis.AlignedRMSF(up, select=sel, engine=engine).run(
        backend=_port_mesh(transfer_dtype=td))
    rmsf = r.results.rmsf
    serial = analysis.AlignedRMSF(up, select=sel).run(
        backend="serial").results.rmsf
    ref = _jax_rmsf(uj, td)
    n_frames = up.trajectory.n_frames
    n_batches = -(-n_frames // (4 * N_SHARDS))
    if engine == "fused" and td != "float32":
        # both passes, every shard of every global batch, no demotion
        assert len(calls) == 2 * n_batches * N_SHARDS
        assert all(s[1] == 4 for s in calls), calls
        assert _fused_blocks() - blocks0 == 2 * n_batches
    else:
        assert not calls
    assert _fallbacks() == fallbacks0 == 0
    generic_tol = 5e-3 if td == "delta" else 5e-4
    np.testing.assert_allclose(rmsf, ref, atol=generic_tol)
    if td in ("float32", "int16", "delta"):
        np.testing.assert_allclose(rmsf, serial, atol=1e-3)
    else:
        # int8 resolves range/120 (coarse by design; the JAX package's
        # mesh dry run holds it to 0.2)
        np.testing.assert_allclose(rmsf, serial, atol=0.2)


def test_aligned_rmsf_mesh_backend_name_and_block_cache(pair):
    up, _ = pair
    cache = executors.DeviceBlockCache()
    r = analysis.AlignedRMSF(up, select=SEL, engine="fused").run(
        backend="mesh", devices=CPU4, batch_size=4, transfer_dtype="int16",
        block_cache=cache)
    # pass 2 reads the blocks pass 1 staged: one entry a global batch
    assert len(cache._store) == -(-30 // 16)
    assert cache.hits == len(cache._store)
    again = analysis.AlignedRMSF(up, select=SEL, engine="fused").run(
        backend=_port_mesh(transfer_dtype="int16"))
    np.testing.assert_array_equal(r.results.rmsf, again.results.rmsf)


def test_more_shards_than_frames():
    """Quirk Q2: 3 frames over 4 shards of 2 — empty shards are all
    padding and merge as zero-frame partials."""
    kw = dict(n_residues=5, n_frames=3, noise=0.1, seed=0)
    up = testing.make_protein_universe(**kw)
    r = analysis.AlignedRMSF(up, select="name CA").run(
        backend=_port_mesh(batch_size=2))
    s = analysis.AlignedRMSF(up, select="name CA").run(backend="serial")
    np.testing.assert_allclose(r.results.rmsf, s.results.rmsf, rtol=5e-3,
                               atol=1e-5)


def test_average_structure_mesh_matches_jax_mesh(pair):
    up, uj = pair
    p = analysis.AverageStructure(up, select=SEL).run(backend=_port_mesh())
    j = jax_analysis.AverageStructure(uj, select=SEL).run(
        backend=_jax_mesh())
    s = analysis.AverageStructure(up, select=SEL).run(backend="serial")
    np.testing.assert_allclose(p.results.positions, s.results.positions,
                               atol=2e-4)
    np.testing.assert_allclose(p.results.positions,
                               np.asarray(j.results.positions), atol=2e-4)


def test_rmsf_mesh_matches_jax_mesh(pair):
    up, uj = pair
    p = analysis.RMSF(up.select_atoms(SEL)).run(backend=_port_mesh())
    j = jax_analysis.RMSF(uj.select_atoms(SEL)).run(backend=_jax_mesh())
    np.testing.assert_allclose(p.results.rmsf, np.asarray(j.results.rmsf),
                               rtol=5e-3, atol=1e-4)


# ------------------------------------------------------------- series

@pytest.mark.parametrize("groups", [None, ["name CB"]])
def test_rmsd_series_in_frame_order(pair, groups):
    up, uj = pair
    kw = dict(select=SEL, groupselections=groups)
    p = analysis.RMSD(up, **kw).run(backend=_port_mesh(batch_size=3))
    j = jax_analysis.RMSD(uj, **kw).run(backend=_jax_mesh(batch_size=3))
    s = analysis.RMSD(up, **kw).run(backend="serial")
    assert p.results.rmsd.shape == (30,)
    np.testing.assert_allclose(p.results.rmsd, s.results.rmsd, rtol=1e-3,
                               atol=2e-4)
    np.testing.assert_allclose(p.results.rmsd, np.asarray(j.results.rmsd),
                               rtol=1e-3, atol=2e-4)
    if groups:
        np.testing.assert_allclose(p.results.group_rmsd,
                                   s.results.group_rmsd, rtol=1e-3,
                                   atol=2e-4)


def test_contacts_series_on_the_mesh(pair):
    up, _ = pair
    kw = dict(select=("name CA", "name CB"),
              refgroup=(up.select_atoms("name CA"),
                        up.select_atoms("name CB")), radius=6.0)
    p = analysis.Contacts(up, **kw).run(backend=_port_mesh(batch_size=3))
    s = analysis.Contacts(up, **kw).run(backend="serial")
    np.testing.assert_allclose(p.results.timeseries, s.results.timeseries,
                               atol=1e-6)


# --------------------------------------------------------------- RDF

@pytest.fixture(scope="module")
def water_pair():
    kw = dict(n_waters=64, n_frames=3, box=15.0)
    return (testing.make_water_universe(**kw),
            jax_testing.make_water_universe(**kw))


def test_interrdf_mesh_matches_jax_mesh(water_pair):
    wp, wj = water_pair
    kw = dict(nbins=40, range=(0.0, 7.0), tile=32)
    op, oj = wp.select_atoms("name OW"), wj.select_atoms("name OW")
    p = analysis.InterRDF(op, op, **kw).run(backend=_port_mesh(
        batch_size=1))
    j = jax_analysis.InterRDF(oj, oj, **kw).run(backend=_jax_mesh(
        batch_size=1))
    s = analysis.InterRDF(op, op, **kw).run(backend="serial")
    np.testing.assert_allclose(p.results.count, s.results.count, atol=3)
    np.testing.assert_allclose(p.results.count, np.asarray(j.results.count),
                               atol=3)
    np.testing.assert_allclose(p.results.rdf, np.asarray(j.results.rdf),
                               rtol=1e-5)


def test_interrdf_s_mesh_matches_jax_mesh(water_pair):
    wp, wj = water_pair

    def ags(u):
        ow = u.select_atoms("name OW")
        hw = u.select_atoms("name HW1")[:2]
        return [(ow[:3], ow[3:7]), (hw, ow[:3])]

    kw = dict(nbins=20, range=(0.0, 6.0))
    p = analysis.InterRDF_s(wp, ags(wp), **kw).run(
        backend=_port_mesh(batch_size=1))
    j = jax_analysis.InterRDF_s(wj, ags(wj), **kw).run(
        backend=_jax_mesh(batch_size=1))
    s = analysis.InterRDF_s(wp, ags(wp), **kw).run(backend="serial")
    for rp, rj, rs in zip(p.results.count, j.results.count,
                          s.results.count):
        np.testing.assert_allclose(np.asarray(rp), rs, atol=1e-6)
        np.testing.assert_allclose(np.asarray(rp), np.asarray(rj),
                                   atol=1e-6)


def test_contact_map_mesh_matches_jax_mesh():
    kw = dict(n_residues=8, n_frames=9, noise=0.3)
    up = testing.make_protein_universe(**kw)
    uj = jax_testing.make_protein_universe(**kw)
    p = analysis.ContactMap(up.select_atoms("name CA"), cutoff=10.0).run(
        backend=_port_mesh(batch_size=2))
    j = jax_analysis.ContactMap(uj.select_atoms("name CA"),
                                cutoff=10.0).run(backend=_jax_mesh(
                                    batch_size=2))
    s = analysis.ContactMap(up.select_atoms("name CA"), cutoff=10.0).run(
        backend="serial")
    np.testing.assert_allclose(p.results.contact_fraction,
                               s.results.contact_fraction, atol=0.01)
    np.testing.assert_allclose(p.results.contact_fraction,
                               np.asarray(j.results.contact_fraction),
                               atol=1e-6)


# ------------------------------------------------------ contract edges

@pytest.mark.parametrize("n_anchors", [2, 4, 8])
def test_delta_anchor_bytes_equal_jax(n_anchors):
    """One keyframe per shard: the port's delta wire with ``n_anchors``
    anchors is the JAX package's, byte for byte."""
    from mdanalysis_mpi_tpu.parallel.executors import (
        quantize_block_delta as jax_qbd)

    u = testing.make_md_universe(n_residues=6, n_frames=16, seed=1)
    block = u.trajectory.read_block(0, 16)[0]
    got = quantize_block_delta(block, n_anchors, n_valid=13)
    want = jax_qbd(block, n_anchors, n_valid=13)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_delta_segments_must_split_evenly():
    block = np.zeros((6, 4, 3), np.float32)
    with pytest.raises(ValueError, match="anchor segments"):
        quantize_block_delta(block, 4)


@pytest.mark.parametrize("kwargs, item", [
    (dict(scan_k=4), "A4"), (dict(scan_k="auto"), "A4"),
    (dict(prestage=True), "A9"), (dict(reliability=object()), "A9")])
def test_deferred_features_name_their_roadmap_item(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        MeshExecutor(devices=CPU4, **kwargs)


def test_registered_backends_and_devices():
    assert {"mesh", "mpi"} <= set(executors._EXECUTORS)
    m = get_executor("mesh", devices="cpu")
    assert m.name == "mesh" and m.devices == [torch.device("cpu")]
    assert MeshExecutor(devices=CPU4).device == torch.device("cpu")
    with pytest.raises(ValueError, match="at least one"):
        MeshExecutor(devices=[])


def test_fold_without_combine_is_refused(pair):
    up, _ = pair

    class Folds(AnalysisBase):
        _device_fold_fn = staticmethod(tree_add)

        def _batch_fn(self):
            return lambda params, batch, boxes, mask: (mask.sum(),)

    a = Folds(up)
    with pytest.raises(ValueError, match="_device_combine"):
        a.run(backend=_port_mesh())
