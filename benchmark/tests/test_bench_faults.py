"""The check that decides ``correct``, on the CPU at a tiny size: a sound run
is correct; a run whose timed path is broken underneath, or whose program
is replaced by the reference in float8, is not.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import pytest

from benchmark.tests import _tiny


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return _tiny.make_checkout(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("cell", [_tiny.TRAIN_CELL, _tiny.RGB_CELL, _tiny.SERVE_CELL])
def test_sound_run_is_correct(checkout, cell):
    out = _tiny.run_cell(checkout, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert out["device"]["count"] == 1


@pytest.mark.parametrize("cell,fault", [
    (_tiny.TRAIN_CELL, "unchanged"), (_tiny.TRAIN_CELL, "half_batch"),
    (_tiny.TRAIN_CELL, "altered_step"), (_tiny.TRAIN_CELL, "altered_labels"),
    (_tiny.RGB_CELL, "unchanged"),
    (_tiny.RGB_CELL, "half_batch"), (_tiny.SERVE_CELL, "altered_answer"),
    (_tiny.SERVE_CELL, "half_answers")])
def test_broken_timed_path_is_not_correct(checkout, cell, fault):
    """The rest of a run (its set-up, window and check) with the program's
    entry broken underneath: a step that leaves its state unchanged, half
    of every batch left out and the mean taken over the rest, an input or
    the labels of the step altered where they are produced, an altered
    class map, half of a request's images answered for the whole batch."""
    out = _tiny.run_cell(checkout, cell, fault)
    assert not out["correct"], out["checks"]


@pytest.fixture(scope="module")
def readings():
    """``calibrate.py``'s readings of each side, by kind, number and side,
    with the bfloat16 program at a size a CPU holds (batch 4 at 96x128),
    on three seeds."""
    import torch

    from benchmark import calibrate
    from benchmark.drivers import serve, train

    torch.set_num_threads(4)
    out = {}
    for kind, mix in (("train", "mcd_train_b24_640x480.json"),
                      ("serve", "serve_b8_closed.json")):
        traffic = _tiny.tiny_traffic(mix)
        traffic["batch"] = 4
        traffic["scene"].update(width=128, height=96)
        for seed in (2**33 + 1, 2**33 + 2, 2**33 + 3):
            run = {"train": train, "serve": serve}[kind].Run(
                _tiny.tiny_config("tiny_d22", "bfloat16"), traffic, seed, "cpu")
            rows = (calibrate._train_seed(run, True) if kind == "train"
                    else calibrate._serve_seed(run, True, traffic["pool"]))
            for side, numbers in rows:
                for number, value in numbers.items():
                    out.setdefault((kind, number, side), []).append(value)
    return out


@pytest.mark.parametrize("kind,number,side", [
    ("train", "input_gap", "control_fp8"),
    ("train", "stats_a_diff_median", "control_fp8"),
    ("train", "stats_a_diff_median", "control_fp8_conv"),
    ("train", "stats_a_diff_median", "fault_bn_momentum"),
    ("train", "grad_gap_median", "fault_half_batch"),
    ("serve", "logit_gap", "control_fp8"),
    ("serve", "class_mismatch", "control_fp8"),
    ("serve", "tile_gap", "control_fp8"),
    ("serve", "tile_gap", "fault_altered_answer")])
def test_control_in_the_programs_place_is_not_correct(readings, kind, number, side):
    """The control (``calibrate.py``: the reference in float8, every tensor
    or only the convolutions) or a planted fault against the bfloat16
    program: on three seeds each of its readings of the number lies over
    twice every program reading, so a limit between them, set as the
    cells' limits are, passes the program and fails the control. (The
    cells' own limits are set from readings at their full size on the
    card.)"""
    from benchmark.lib import check

    program = readings[(kind, number, "program")]
    other = readings[(kind, number, side)]
    lower, upper = max(program), min(other)
    assert upper > 2 * lower, (program, other)
    limit = {number: lower * (upper / lower) ** 0.5}
    assert all(check.judge({number: v}, limit)[0] for v in program)
    assert not any(check.judge({number: v}, limit)[0] for v in other)
