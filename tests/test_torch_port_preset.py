"""`automoe-train-torch preset` (automoe_tpu_torch/train/cli.py) against the
JAX CLI's `_expand_preset`: the port's presets are the JAX package's files
byte for byte, each expands to the same argv, `--list` names them, and
`preset quick_test` trains one epoch on the CPU."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from tests.torch_port_common import tmp_path  # noqa: F401  (removes what tests write)

JAX_PRESETS = Path(__file__).resolve().parents[1] / "automoe_tpu" / "configs" / "presets"
NAMES = sorted(p.stem for p in JAX_PRESETS.glob("*.json"))


def test_there_are_nine_presets():
    from automoe_tpu_torch.train.cli import PRESET_DIR

    assert len(NAMES) == 9
    assert sorted(p.stem for p in PRESET_DIR.glob("*.json")) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_preset_expands_as_jax(name):
    from automoe_tpu.train.cli import _expand_preset as jax_expand

    from automoe_tpu_torch.train.cli import PRESET_DIR, _expand_preset

    assert (PRESET_DIR / f"{name}.json").read_bytes() == (JAX_PRESETS / f"{name}.json").read_bytes()
    overrides = ["--epochs", "2", "--run-name", "mine"]
    for argv in (["preset", name], ["preset", name, *overrides],
                 ["preset", f"{name}.json", *overrides], ["preset", str(JAX_PRESETS / f"{name}.json")]):
        assert _expand_preset(argv) == jax_expand(argv), argv


@pytest.mark.parametrize("flag", [None, "--list", "-l"])
def test_preset_list_prints_the_names(flag, capsys):
    from automoe_tpu_torch.train.cli import main

    with pytest.raises(SystemExit) as e:
        main(["preset"] + ([flag] if flag else []))
    assert e.value.code == 0
    assert capsys.readouterr().out.split() == NAMES


def test_preset_quick_test_trains_on_the_cpu(tmp_path):
    """quick_test (bdd --task drivable, 64 px, batch 4, 1 epoch) on a
    synthetic BDD drivable cache; the trailing overrides reach the run."""
    from automoe_tpu_torch.tools.synth import main as synth
    from automoe_tpu_torch.train.cli import main

    root = tmp_path / "drv"
    synth([str(root), "--format", "bdd-drivable", "--size", "64", "--train", "8", "--val", "4"])
    res = main(["preset", "quick_test", "--data-root", str(root), "--device", "cpu",
                "--runs-root", str(tmp_path / "runs"), "--ckpt-root", str(tmp_path / "ckpt"),
                "--seed", "3"])
    assert res["best_val_loss"] == res["best_val_loss"]  # finite, not NaN
    run = tmp_path / "runs" / "bdd_drivable_quick_test"
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert len([r for r in recs if "train/loss_epoch" in r]) == 1
    assert (tmp_path / "ckpt" / "bdd_drivable").is_dir()
