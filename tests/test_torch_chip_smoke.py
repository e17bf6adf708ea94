"""The phase selection of ``chip_smoke.py`` and the launch counts of its
kernel table line, on the CPU (the phases themselves need a card)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def test_no_argument_selects_every_phase():
    assert chip_smoke.select_phases([]) == set(chip_smoke.PHASE_ORDER)


def test_a_selection_always_adds_device_and_build():
    assert chip_smoke.select_phases(["--phases", "3,4,13"]) == {
        1, 2, 3, 4, 13}


@pytest.mark.parametrize("arg, missing", [("6", 4), ("8,13", 4),
                                          ("5", 3), ("3,10", 4),
                                          ("14", 4), ("3,8,14", 4),
                                          ("15", 4), ("3,5,15", 4),
                                          ("16", 4), ("3,5,15,16", 4),
                                          ("17", 4), ("3,5,17", 4)])
def test_a_selection_without_a_needed_phase_is_refused(arg, missing):
    with pytest.raises(ValueError, match=f"select phase {missing} too"):
        chip_smoke.select_phases(["--phases", arg])


@pytest.mark.parametrize("argv", [["--phases", "99"], ["--phases", "a"],
                                  ["--fast"], ["--phases"]])
def test_bad_arguments_are_refused(argv):
    with pytest.raises(ValueError):
        chip_smoke.select_phases(argv)


@pytest.mark.parametrize("kernel_phases", [chip_smoke.FUSED_PHASES,
                                           chip_smoke.PH_PHASES])
def test_launches_count_only_when_the_whole_main_path_ran(kernel_phases,
                                                          capsys):
    every = set(chip_smoke.PHASE_ORDER)
    assert chip_smoke.main_path_launches("k", 7, kernel_phases, every) == 7
    assert capsys.readouterr().out == ""
    part = chip_smoke.select_phases(["--phases", "3,4,13"])
    assert chip_smoke.main_path_launches("k", 0, kernel_phases,
                                         part) is None
    assert "null" in capsys.readouterr().out


def test_every_launching_phase_is_a_phase():
    order = set(chip_smoke.PHASE_ORDER)
    assert set(chip_smoke.FUSED_PHASES) <= order
    assert set(chip_smoke.PH_PHASES) <= order


def test_phase_14_runs_after_8_and_counts_on_the_fused_path(capsys):
    order = chip_smoke.PHASE_ORDER
    assert order.index(14) == order.index(8) + 1
    assert 14 in chip_smoke.FUSED_PHASES and 14 in chip_smoke.WATER_PHASES
    assert chip_smoke.select_phases(["--phases", "3,4,14"]) == {
        1, 2, 3, 4, 14}
    # a run without phase 14 prints a null fused count, not a partial one
    part = chip_smoke.select_phases(["--phases", "3,4,8,9,10"])
    assert chip_smoke.main_path_launches(
        "fused", 40, chip_smoke.FUSED_PHASES, part) is None
    out = capsys.readouterr().out
    assert "null" in out and "[4, 8, 9, 10]" in out


def test_phase_15_runs_after_5_and_counts_on_both_paths(capsys):
    """The serving phase runs right after phase 5 (on its water box and
    phase 4's system) and before phase 4's system is dropped; both
    kernels' main-path counts include it."""
    order = chip_smoke.PHASE_ORDER
    assert order.index(15) == order.index(5) + 1
    assert order.index(15) < order.index(7) and order.index(15) < \
        order.index(11)
    assert chip_smoke.NEEDS[15] == 4 and 15 in chip_smoke.WATER_PHASES
    assert 15 in chip_smoke.FUSED_PHASES and 15 in chip_smoke.PH_PHASES
    assert chip_smoke.select_phases(["--phases", "3,4,5,15"]) == {
        1, 2, 3, 4, 5, 15}
    # a run without phase 15 prints null counts for both kernels
    part = chip_smoke.select_phases(["--phases", "3,4,5,8,9,10,14"])
    for name, phases in (("fused", chip_smoke.FUSED_PHASES),
                         ("pair_histogram", chip_smoke.PH_PHASES)):
        assert chip_smoke.main_path_launches(name, 40, phases,
                                             part) is None
    out = capsys.readouterr().out
    assert "[4, 8, 14, 9, 10]" in out and "[5, 10]" in out


def test_phase_16_runs_after_15_and_counts_its_hosts_fused_launches(capsys):
    """The fleet phase runs right after the serving phase, on phase 4's
    system and the water box; its fleet hosts' fused launches (their
    federated counter) join the fused kernel's main-path count, and no
    counter brings their pair-histogram launches across processes."""
    order = chip_smoke.PHASE_ORDER
    assert order.index(16) == order.index(15) + 1
    assert order.index(16) < order.index(7) and order.index(16) < \
        order.index(11)
    assert chip_smoke.NEEDS[16] == 4 and 16 in chip_smoke.WATER_PHASES
    assert 16 in chip_smoke.FUSED_PHASES
    assert 16 not in chip_smoke.PH_PHASES
    assert chip_smoke.select_phases(["--phases", "3,4,16"]) == {
        1, 2, 3, 4, 16}
    assert chip_smoke.select_phases(["--phases", "3,4,5,16"]) == {
        1, 2, 3, 4, 5, 16}
    # a run without phase 16 prints a null fused count, not a partial one
    part = chip_smoke.select_phases(["--phases", "3,4,5,8,9,10,14,15,17"])
    assert chip_smoke.main_path_launches(
        "fused", 40, chip_smoke.FUSED_PHASES, part) is None
    assert chip_smoke.main_path_launches(
        "pair_histogram", 12, chip_smoke.PH_PHASES, part) == 12
    out = capsys.readouterr().out
    assert "[4, 8, 14, 15, 9, 10, 17]" in out
    # the CPU rehearsal's switches exist and default to the card
    assert chip_smoke.FLEET_DEVICE == "cuda"
    assert chip_smoke.FLEET_CLI_ARGS == ()


def test_phase_17_runs_after_13_and_counts_on_both_paths(capsys):
    """The lint phase runs on phase 4's system and the water box before
    they are dropped; the launches of its capture tier join both
    kernels' main-path counts."""
    order = chip_smoke.PHASE_ORDER
    assert order.index(17) == order.index(13) + 1
    assert order.index(17) < order.index(7) and order.index(17) < \
        order.index(11)
    assert chip_smoke.NEEDS[17] == 4 and 17 in chip_smoke.WATER_PHASES
    assert 17 in chip_smoke.FUSED_PHASES and 17 in chip_smoke.PH_PHASES
    assert chip_smoke.select_phases(["--phases", "3,4,17"]) == {
        1, 2, 3, 4, 17}
    # a run without phase 17 prints null counts for both kernels
    part = chip_smoke.select_phases(["--phases",
                                     "3,4,5,8,9,10,14,15,16"])
    for name, phases in (("fused", chip_smoke.FUSED_PHASES),
                         ("pair_histogram", chip_smoke.PH_PHASES)):
        assert chip_smoke.main_path_launches(name, 40, phases,
                                             part) is None
    out = capsys.readouterr().out
    assert "[4, 8, 14, 15, 16, 9, 10]" in out and "[5, 15, 10]" in out


def test_phase_18_runs_last_and_needs_no_other_phase():
    assert chip_smoke.PHASE_ORDER[-1] == 18
    assert 18 not in chip_smoke.NEEDS
    assert 18 not in chip_smoke.FUSED_PHASES + chip_smoke.PH_PHASES
    assert chip_smoke.select_phases(["--phases", "18"]) == {1, 2, 18}


def test_phase_18_fused_draws_force_the_geometry_corners():
    """The forced cases alone (8 first, the 3 wide ones last) reach
    every corner the phase checks, on the H100's 132 SMs; the drawn ones
    stay within the main shape and are those of the seed without the
    wide corners."""
    import numpy as np

    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp

    draws = chip_smoke.fuzz_fused_draws(np.random.default_rng(0), 132)
    assert len(draws) == chip_smoke.FUZZ_FUSED_CASES + 11
    seen = set()
    for B, n_real, dtype, _ in draws[:8] + draws[-3:]:
        S = -(-n_real // 256) * 256
        seen.add((dtype, S) + fp.fused_geometry(
            B, S, chip_smoke.FUZZ_DTYPES[dtype], 132))
    chip_smoke.fuzz_geometry_reached(seen, 132)
    for (B, n_real, dtype, _), itemsize in zip(draws[-3:], (2, 1, 4)):
        assert -(-n_real // 256) * 256 == fp.fused_max_atoms(itemsize,
                                                             132) + 256
    for B, n_real, dtype, _ in draws[8:-3]:
        assert 1 <= B < 600 and 1 <= n_real < 70000
        assert B * (-(-n_real // 256) * 256) <= chip_smoke.FUZZ_MAX_ELEMS


def test_phase_18_rehearsed_on_the_cpu(monkeypatch, capsys):
    """Phase 18 end to end at a small size on the CPU: the plain
    versions stand in for the kernels (wrapped to count as the kernels'
    wrappers do), the graph replay is two eager calls, ``'auto'``
    resolves to the kernel route as on the card."""
    import torch

    from mdanalysis_mpi_tpu_torch import _build
    from mdanalysis_mpi_tpu_torch.analysis import InterRDF
    from mdanalysis_mpi_tpu_torch.ops import fused_distances as fd
    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp

    def counting(plain, wrapper):
        def run(*a, **k):
            _build.count_launch(wrapper)
            return plain(*a, **k)
        return run

    monkeypatch.setattr(fp, "planar_sums_plain",
                        counting(fp.planar_sums_plain, fp.planar_sums))
    monkeypatch.setattr(fd, "pair_histogram_plain",
                        counting(fd.pair_histogram_plain, fd.pair_histogram))
    resolve = InterRDF._resolve_engine

    def on_card(self):
        if self._engine == "auto":
            self._resolved_engine = "pallas"
        return resolve(self)

    monkeypatch.setattr(InterRDF, "_resolve_engine", on_card)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "sm_count", lambda device: 132)
    monkeypatch.setattr(chip_smoke, "replay", lambda fn: [fn(), fn()])
    for name, value in [("FUZZ_FUSED_CASES", 3), ("FUZZ_PH_CASES", 4),
                        ("FUZZ_RUN_SEEDS", 1), ("FUZZ_MAX_ELEMS", 40_000),
                        ("FUZZ_WATERS", (60, 90)), ("FUZZ_DEVICE", "cpu"),
                        ("FUZZ_MESH", ["cpu"] * 2)]:
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(fp.planar_sums, "launches", 0)
    monkeypatch.setattr(fd.pair_histogram, "launches", 0)
    c_fused, c_ph = chip_smoke.phase_fuzz("cpu (rehearsal)")
    assert c_fused > 0 and c_ph > 0
    out = capsys.readouterr().out
    assert "fuzz seed 18" in out and "fuzz phase launches" in out
    assert "stages 2" in out and "group 1" in out


def test_phase_19_rehearsed_on_the_cpu(monkeypatch, capsys):
    """Phase 19 end to end at a small size on the CPU: the single-read
    limit lowered below the selection (so the geometry is the wide
    mode's), the plain version wrapped to count as the kernel's wrapper
    does; fused against generic, the repeat, the oracle and the
    fallback counter all checked."""
    import torch

    from mdanalysis_mpi_tpu_torch import _build
    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp

    plain = fp.planar_sums_plain

    def counted(*a):
        _build.count_launch(fp.planar_sums)
        return plain(*a)

    monkeypatch.setattr(fp, "planar_sums_plain", counted)
    monkeypatch.setattr(fp, "fused_max_atoms", lambda itemsize, n_sm: 512)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "sm_count", lambda device: 132)
    for name, value in [("WIDE_ATOMS", 4000), ("WIDE_FRAMES", 24),
                        ("WIDE_BATCH", 8), ("WIDE_ORACLE", 8),
                        ("WIDE_DEVICE", "cpu")]:
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(fp.planar_sums, "launches", 0)
    launches = chip_smoke.phase_wide("cpu (rehearsal)")
    # three wires and a repeat, 3 blocks x 2 passes each; the oracle's
    # fused run, 1 block x 2 passes
    assert launches == 4 * 6 + 2
    out = capsys.readouterr().out
    assert "wide int16: repeat bit-identical" in out
    assert "mdtpu_fused_fallbacks_total +0" in out
    assert "[4, 8, 14, 15, 16, 9, 10, 17]" not in out
