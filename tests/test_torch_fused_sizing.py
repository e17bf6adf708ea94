"""The launch geometry of the fused aligned-moments kernel
(``ops/fused_planar.fused_geometry``), checked on the CPU without JAX.

The kernel (``csrc/fused_rmsf.cu``) gives each block a contiguous slice
of atoms and copies frames in groups into a ring of shared-memory
stages; the geometry decides the slice, the group and the ring from
``(B, S, dtype, SM count)``.  These tests hold it to the kernel's
envelope: every atom in exactly one slice, slices a multiple of 16
atoms (16-byte rows for every dtype), a block's shared memory within
the 232,448 bytes Hopper allows, at least one frame a group, at most
one block per SM, and the wrapper's limit (``S % 256 == 0``).  Above
:func:`fused_max_atoms` (the single-read form's limit) the geometry is
the kernel's wide mode, whose last three entries are pass A's chunk and
pass B's frames and chunk, each unit one tensor-map box a stage holds:
the chunks of either pass cover each slice, the boxes' rows are whole
16-byte runs of at most 2,048 bytes, and the ring of units fits beside
the window of records.
That the kernel's own layout agrees with this sizing is held on the
card (tests/test_torch_cuda.py: a launch at the limit goes through, one
more stage is refused; the first wide S of each dtype runs).
"""

import pytest

from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp


@pytest.mark.parametrize("n_sm", [114, 132])
@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("S", [256, 50176])
@pytest.mark.parametrize("B", [1, 33, 511, 512])
def test_geometry_covers_every_atom_and_fits(B, S, itemsize, n_sm):
    slice_atoms, blocks, group, stages = fp.fused_geometry(B, S, itemsize,
                                                           n_sm)
    assert slice_atoms % fp.SLICE_ATOMS == 0 and slice_atoms >= 16
    # every atom in exactly one slice: block b owns [b*slice, ...) and
    # only the last block's slice is cut short
    assert (blocks - 1) * slice_atoms < S <= blocks * slice_atoms
    owned = [min(slice_atoms, S - b * slice_atoms) for b in range(blocks)]
    assert sum(owned) == S and min(owned) > 0
    assert all(n % fp.SLICE_ATOMS == 0 for n in owned)
    assert blocks <= n_sm
    assert 1 <= group <= min(B, 24 // itemsize)
    assert 2 <= stages <= fp.MAX_STAGES
    assert fp.fused_smem_bytes(slice_atoms, group, stages,
                               itemsize) <= fp.SMEM_MAX


def test_main_shape_geometry():
    """The worked sizing of the CUDA source's header: 50,176 atoms on
    132 SMs → 131 blocks of 384 atoms, 24 bytes an atom-row a stage,
    seven stages."""
    for itemsize, group in ((2, 12), (1, 24), (4, 6)):
        assert fp.fused_geometry(512, 50176, itemsize, 132) == (
            384, 131, group, 7)
    assert fp.fused_smem_bytes(384, 12, 7, 2) == 212_480


def _chunks(owned, chunk):
    return [min(chunk, owned - c0) for c0 in range(0, owned, chunk)]


def _assert_wide_fits(B, S, itemsize, n_sm):
    """The wide geometry: every atom in exactly one slice, every slice
    covered by each pass's chunks in order, at most one block per SM,
    pass A's chunk a multiple of 128 atoms (four a lane) in one box row
    and pass B's in equal box rows of whole granules, and the ring of
    units beside the records window within the shared memory a block may
    use."""
    geometry = fp.fused_geometry(B, S, itemsize, n_sm)
    assert len(geometry) == 7
    slice_atoms, blocks, group, stages, chunk, group_b, chunk_b = geometry
    assert slice_atoms % fp.SLICE_ATOMS == 0
    assert (blocks - 1) * slice_atoms < S <= blocks * slice_atoms
    assert blocks <= min(n_sm, fp.MAX_BLOCKS)
    assert chunk % 128 == 0 and chunk * itemsize <= fp.WIDE_BOX_BYTES
    nbox = fp.wide_boxes(chunk_b, itemsize)
    assert 16 <= chunk_b <= fp.WIDE_CHUNK_B
    assert chunk_b % (fp.SLICE_ATOMS * nbox) == 0
    assert chunk_b // nbox * itemsize <= fp.WIDE_BOX_BYTES
    # every block but the last owns a whole slice
    for owned in {slice_atoms, S - (blocks - 1) * slice_atoms}:
        for size in (chunk, chunk_b):
            chunks = _chunks(owned, size)
            assert sum(chunks) == owned and min(chunks) > 0
            assert all(n % fp.SLICE_ATOMS == 0 for n in chunks)
    assert 1 <= group <= min(B, fp.WIDE_GROUP)
    assert 1 <= group_b <= min(B, fp.MAX_GROUP)
    assert 2 <= stages <= fp.MAX_STAGES
    assert fp.wide_smem_bytes(B, group, chunk, group_b, chunk_b, stages,
                              itemsize) <= fp.SMEM_MAX
    return geometry


@pytest.mark.parametrize("n_sm", [114, 132])
@pytest.mark.parametrize("itemsize", [1, 2, 4])
def test_limit_is_exact(itemsize, n_sm):
    """S = the limit takes one frame a group or more in the single-read
    form; S one padding granule above it takes the wide mode, because
    its slice cannot hold even one frame in two stages."""
    limit = fp.fused_max_atoms(itemsize, n_sm)
    assert limit % 256 == 0 and limit > 16384
    slice_atoms, blocks, group, stages = fp.fused_geometry(512, limit,
                                                           itemsize, n_sm)
    assert group >= 1 and stages >= 2 and blocks <= n_sm
    assert fp.fused_smem_bytes(slice_atoms, group, stages,
                               itemsize) <= fp.SMEM_MAX
    above = limit + 256
    slice_above = 16 * -(-(above // 16) // n_sm)
    assert fp.fused_smem_bytes(slice_above, 1, 2, itemsize) > fp.SMEM_MAX
    geometry = _assert_wide_fits(512, above, itemsize, n_sm)
    assert geometry[0] == slice_above
    assert max(geometry[4], geometry[6]) < slice_above


@pytest.mark.parametrize("n_sm", [114, 132])
@pytest.mark.parametrize("itemsize", [1, 2, 4])
def test_wide_geometry_from_the_limit_to_4m_atoms(itemsize, n_sm):
    """Every multiple of 256 from the single-read limit + 256 up to
    4,194,304 atoms (odd multiples of 256 among them) takes a launchable
    wide geometry, for one frame, a group's worth and a main-path
    block."""
    limit = fp.fused_max_atoms(itemsize, n_sm)
    for S in range(limit + 256, 4_194_304 + 1, 256):
        _assert_wide_fits(512, S, itemsize, n_sm)
    for B in (1, 5, 13, 25, 509, 1024, 1500):
        for S in (limit + 256, limit + 768, 1_048_576, 4_194_304):
            _assert_wide_fits(B, S, itemsize, n_sm)


@pytest.mark.parametrize("n_sm", [114, 132])
@pytest.mark.parametrize("itemsize", [1, 2, 4])
def test_every_width_below_the_limit_keeps_the_single_read_form(itemsize,
                                                               n_sm):
    """Up to the single-read limit every multiple of 256 keeps a
    four-entry geometry that fits, as before the wide mode."""
    limit = fp.fused_max_atoms(itemsize, n_sm)
    for S in range(256, limit + 1, 256):
        geometry = fp.fused_geometry(512, S, itemsize, n_sm)
        assert len(geometry) == 4
        slice_atoms, _, group, stages = geometry
        assert fp.fused_smem_bytes(slice_atoms, group, stages,
                                   itemsize) <= fp.SMEM_MAX


def test_wide_geometry_at_a_million_atoms():
    """The worked sizing of the CUDA source's header: S = 1,048,576 on
    132 SMs, B = 512 → 132 slices of 7,952 atoms; pass A 12 frames of
    512 / 896 / 256 atoms (int16 / int8 / float32), pass B 6 / 12 / 3
    frames of 1,344 / 1,328 / 1,344 atoms in 2 / 1 / 3 boxes, four
    stages beside 32 KB of records."""
    for itemsize, chunk, group_b, chunk_b, nbox in ((2, 512, 6, 1344, 2),
                                                    (1, 896, 12, 1328, 1),
                                                    (4, 256, 3, 1344, 3)):
        assert fp.fused_geometry(512, 1_048_576, itemsize, 132) == (
            7952, 132, 12, 4, chunk, group_b, chunk_b)
        assert fp.wide_boxes(chunk_b, itemsize) == nbox
    assert fp.wide_smem_bytes(512, 12, 512, 6, 1344, 4, 2) == 226_816


def test_main_limits_on_132_sms():
    assert [fp.fused_max_atoms(i, 132) for i in (1, 2, 4)] == [
        663_040, 587_008, 477_184]


@pytest.mark.parametrize("S", [0, 16, 255, 300, 50176 + 16])
def test_unpadded_selection_raises(S):
    with pytest.raises(ValueError, match="multiple of 256"):
        fp.fused_geometry(512, S, 2, 132)

