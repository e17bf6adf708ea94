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
                                          ("16", 4), ("3,5,15,16", 4)])
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
    part = chip_smoke.select_phases(["--phases", "3,4,5,8,9,10,14,15"])
    assert chip_smoke.main_path_launches(
        "fused", 40, chip_smoke.FUSED_PHASES, part) is None
    assert chip_smoke.main_path_launches(
        "pair_histogram", 12, chip_smoke.PH_PHASES, part) == 12
    out = capsys.readouterr().out
    assert "[4, 8, 14, 15, 9, 10]" in out
    # the CPU rehearsal's switches exist and default to the card
    assert chip_smoke.FLEET_DEVICE == "cuda"
    assert chip_smoke.FLEET_CLI_ARGS == ()
