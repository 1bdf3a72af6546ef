"""chip_smoke.py's plan of a run, on the CPU: the full run's own phases and
its worker groups cover every phase and every run of phases 13 and 16
exactly once, the argument modes parse as documented, and a worker that fails
fails the run with its error.  The smoke test itself needs the card."""

import time

import pytest

import chip_smoke


def test_worker_groups_cover_every_phase_once():
    plans = [chip_smoke.parse_phases(spec)
             for spec in (chip_smoke.PARENT_PHASES, *chip_smoke.WORKER_GROUPS)]
    for phase in chip_smoke.ALL_PHASES - {0, 13, 16}:
        owners = [i for i, (phases, _) in enumerate(plans) if phase in phases]
        assert len(owners) == 1, (phase, owners)
    for part in chip_smoke.PARTS:   # 13a-13e as letters, 16a-16e
        owners = [i for i, (_, parts) in enumerate(plans) if part in parts]
        assert len(owners) == 1, (part, owners)
    assert all(0 in phases for phases, _ in plans)
    # 9d reuses 8d's solutions; the kernel timings stay with the parent
    assert all((8 in phases) == (9 in phases) for phases, _ in plans)
    assert plans[0] == (frozenset({0, 1, 2, 5, 13}), frozenset("a"))


@pytest.mark.parametrize("argv, phases, parts, mode", [
    ([], chip_smoke.ALL_PHASES, chip_smoke.PARTS, "full"),
    (["--serial"], chip_smoke.ALL_PHASES, chip_smoke.PARTS, "serial"),
    (["--phases", "1,14"], {0, 1, 14}, set(), "check"),
    (["--phases", "9"], {0, 8, 9}, set(), "check"),
    (["--phases", "15"], {0, 15}, set(), "check"),
    (["--phases", "12-13"], {0, 12, 13}, chip_smoke.PARTS13, "check"),
    (["--worker", "--phases", "3,13b-d"], {0, 3, 13}, {"b", "c", "d"}, "worker"),
    (["--worker", "--phases", "13e,13a"], {0, 13}, {"a", "e"}, "worker"),
    (["--phases", "16"], {0, 16}, chip_smoke.PARTS16, "check"),
    (["--worker", "--phases", "16b-e"], {0, 16}, {"16b", "16c", "16d", "16e"}, "worker"),
    (["--phases", "17"], {0, 17}, {f"17{c}" for c in "abcdef"}, "check"),
    (["--phases", "17b,17e-f"], {0, 17}, {"17b", "17e", "17f"}, "check"),
    (["--phases", "18"], {0, 18}, set(), "check"),
    (["--worker", "--phases", "16b-e,18"], {0, 16, 18}, {"16b", "16c", "16d", "16e"}, "worker"),
])
def test_parse_args(argv, phases, parts, mode):
    assert chip_smoke.parse_args(argv) == (frozenset(phases), frozenset(parts), mode)


@pytest.mark.parametrize("argv", [["--phases"], ["--phases", "19"], ["--worker"],
                                  ["--serial", "--phases", "1"], ["-x"]])
def test_parse_args_refuses(argv):
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(argv)


def test_failed_worker_fails_the_run():
    """Without CUDA a worker exits 1 at once: the run stops the others
    (or finds them failed too) and raises with each group's exit, long
    before the deadline."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        chip_smoke.run_workers(("3", "13e"), 120.0)
    assert time.monotonic() - t0 < 100.0
    msg = str(err.value)
    assert all(f"worker {group}: exit " in msg for group in ("3", "13e"))
    assert "exit 1: chip_smoke: CUDA is not available" in msg
