"""Twin of ``tests/test_chain.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

ChainReader: multi-file trajectories as one (restart segments)."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.chain import ChainReader
from mdanalysis_mpi_tpu_torch.io.xtc import XTCReader, write_xtc
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    assert_same, both, port_runs_on_the_cpu)


@pytest.fixture
def parts(tmp_path):
    """One 14-frame trajectory written as 3 segment files (5+5+4)."""
    u = make_protein_universe(n_residues=5, n_frames=14, noise=0.3)
    block, _ = u.trajectory.read_block(0, 14)
    dims = np.array([30.0, 30, 30, 90, 90, 90])
    paths = []
    for k, (a, b) in enumerate([(0, 5), (5, 10), (10, 14)]):
        p = str(tmp_path / f"part{k}.xtc")
        write_xtc(p, block[a:b], dimensions=dims,
                  times=np.arange(a, b, dtype=np.float32))
        paths.append(p)
    return u, block, paths


class TestChainReader:
    def test_frames_and_random_access(self, parts):
        u, block, paths = parts
        c = ChainReader(paths)
        assert c.n_frames == 14
        assert c.n_atoms == u.atoms.n_atoms
        for i in (0, 4, 5, 9, 10, 13):
            ts = c[i]
            assert ts.frame == i            # global numbering
            np.testing.assert_allclose(ts.positions, block[i], atol=2e-2)
        assert c.filenames == paths

    def test_read_block_across_boundaries(self, parts):
        u, block, paths = parts
        c = ChainReader(paths)
        got, boxes = c.read_block(3, 12)
        np.testing.assert_allclose(got, block[3:12], atol=2e-2)
        np.testing.assert_allclose(boxes[:, :3], 30.0, atol=1e-3)
        sel = np.array([0, 7, 11])
        gsel, _ = c.read_block(2, 13, sel=sel)
        np.testing.assert_allclose(gsel, block[2:13][:, sel], atol=2e-2)
        strided, _ = c.read_block(1, 14, step=3)     # crosses both seams
        np.testing.assert_allclose(strided, block[1:14:3], atol=2e-2)
        empty, b0 = c.read_block(6, 6)
        assert empty.shape[0] == 0 and b0 is None

    def test_universe_list_construction_and_analysis(self, parts):
        u, block, paths = parts
        uc = Universe(u.topology, paths)
        assert uc.trajectory.n_frames == 14
        from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF

        whole = AlignedRMSF(u, select="name CA").run(backend="serial")
        chain_s = AlignedRMSF(uc, select="name CA").run(backend="serial")
        chain_j = AlignedRMSF(uc, select="name CA").run(backend="torch",
                                                        batch_size=4)
        np.testing.assert_allclose(chain_s.results.rmsf,
                                   whole.results.rmsf, atol=5e-3)
        np.testing.assert_allclose(np.asarray(chain_j.results.rmsf),
                                   chain_s.results.rmsf, atol=1e-4)

    def test_copy_and_times(self, parts):
        u, block, paths = parts
        uc = Universe(u.topology, paths)
        u2 = uc.copy()
        u2.trajectory[8]
        uc.trajectory[1]
        assert u2.trajectory.ts.frame == 8
        assert uc.trajectory.ts.frame == 1
        t = uc.trajectory.frame_times([0, 5, 13])
        np.testing.assert_allclose(t, [0.0, 5.0, 13.0], atol=1e-5)

    def test_int16_staging_through_chain(self, parts):
        u, block, paths = parts
        c = ChainReader(paths)
        sel = np.arange(0, c.n_atoms, 2)
        q, boxes, inv = c.stage_block(3, 12, sel=sel, quantize=True)
        assert q.dtype == np.int16
        np.testing.assert_allclose(q.astype(np.float32) * inv,
                                   block[3:12][:, sel], atol=5e-2)

    def test_child_transformations_rejected(self, parts):
        from mdanalysis_mpi_tpu_torch import transformations as trf

        u, block, paths = parts
        r0 = XTCReader(paths[0])
        r0.add_transformations(trf.translate([1.0, 0, 0]))
        with pytest.raises(ValueError, match="ChainReader itself"):
            ChainReader([r0, paths[1]])

    def test_child_transformations_after_chaining_rejected(self, parts):
        """add_transformations on a CHILD after construction must fail
        at dispatch, not silently skew per-frame vs block reads
        (ADVICE r3)."""
        from mdanalysis_mpi_tpu_torch import transformations as trf

        u, block, paths = parts
        c = ChainReader(paths)
        c[0]                                   # healthy before
        c._readers[0].add_transformations(trf.translate([1.0, 0, 0]))
        with pytest.raises(ValueError, match="ChainReader itself"):
            c[0]
        with pytest.raises(ValueError, match="ChainReader itself"):
            c.read_block(0, 2)
        with pytest.raises(ValueError, match="ChainReader itself"):
            c.stage_block(0, 2)

    def test_chain_level_transformations_consistent(self, parts):
        from mdanalysis_mpi_tpu_torch import transformations as trf

        u, block, paths = parts
        c = ChainReader(paths)
        c.add_transformations(trf.translate([0, 0, 2.0]))
        per_frame = c[6].positions
        blk, _ = c.read_block(6, 7)
        np.testing.assert_allclose(blk[0], per_frame, atol=1e-5)
        np.testing.assert_allclose(per_frame, block[6] + [0, 0, 2.0],
                                   atol=3e-2)

    def test_aligntraj_guard_covers_part_files(self, parts):
        from mdanalysis_mpi_tpu_torch.analysis import AlignTraj

        u, block, paths = parts
        uc = Universe(u.topology, paths)
        with pytest.raises(ValueError, match="part of"):
            AlignTraj(uc, in_memory=False,
                      filename=paths[1]).run(backend="serial")
        assert XTCReader(paths[1]).n_frames == 5   # input intact

    def test_single_child_window_uses_fused_stage(self, parts):
        """A window inside one segment must produce the child's own
        fused int16 staging (hint state lands on the child)."""
        u, block, paths = parts
        c = ChainReader(paths)
        sel = np.arange(0, c.n_atoms, 2)
        q1, _, inv1 = c.stage_block(0, 4, sel=sel, quantize=True)
        assert "_quant_max_hints" in c._readers[0].__dict__
        r = XTCReader(paths[0])
        q2, _, inv2 = r.stage_block(0, 4, sel=sel, quantize=True)
        np.testing.assert_array_equal(q1, q2)
        assert np.float32(inv1) == np.float32(inv2)

    def test_validation(self, tmp_path, parts):
        u, block, paths = parts
        with pytest.raises(ValueError, match="at least one"):
            ChainReader([])
        other = str(tmp_path / "other.xtc")
        write_xtc(other, np.zeros((2, 7, 3), np.float32))
        with pytest.raises(ValueError, match="atoms"):
            ChainReader([paths[0], other])


def test_mixed_format_chain(tmp_path):
    """One logical trajectory spliced from XTC + NetCDF + XYZ segments:
    the chain dispatches each child by extension and block reads cross
    the format boundaries."""
    from mdanalysis_mpi_tpu_torch.core.universe import Universe
    from mdanalysis_mpi_tpu_torch.io.netcdf import write_ncdf
    from mdanalysis_mpi_tpu_torch.io.xtc import write_xtc
    from mdanalysis_mpi_tpu_torch.io.xyz import write_xyz
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    u0 = make_protein_universe(n_residues=5, n_frames=9, noise=0.3,
                               seed=8)
    fr, _ = u0.trajectory.read_block(0, 9)
    p1 = str(tmp_path / "a.xtc")
    p2 = str(tmp_path / "b.nc")
    p3 = str(tmp_path / "c.xyz")
    write_xtc(p1, fr[:3])
    write_ncdf(p2, fr[3:6])
    write_xyz(p3, fr[6:])
    u = Universe(u0.topology, [p1, p2, p3])
    assert u.trajectory.n_frames == 9
    # frames renumber globally; positions match the source (XTC is
    # 0.001-A quantized, XYZ 1e-6 text)
    np.testing.assert_allclose(u.trajectory[4].positions, fr[4],
                               atol=1e-5)
    np.testing.assert_allclose(u.trajectory[8].positions, fr[8],
                               atol=1e-4)
    block, _ = u.trajectory.read_block(2, 7)      # spans two boundaries
    np.testing.assert_allclose(block, fr[2:7], atol=1e-2)


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


def test_chain_matches_jax_package(tmp_path):
    """Two XTC parts through each package's ChainReader: the same frame
    count, frames, times and per-frame dimensions."""
    rng = np.random.default_rng(8)
    parts = []
    for i, n in enumerate((5, 3)):
        p = str(tmp_path / f"part{i}.xtc")
        write_xtc(p, rng.uniform(0, 20, size=(n, 30, 3)).astype(np.float32))
        parts.append(p)

    def case(mod):
        r = mod("io.chain").ChainReader(parts)
        frames, times = r.read_block(0, r.n_frames)
        return r.n_frames, frames, times, r[6].positions
    assert_same(*both(case))
