"""The port's train step on the fused training path against the JAX
package (CPU, float32, `tiny`, take4 gather): the five `_train` flags of
the fused path set together, the reference's Pallas VJPs in interpret
mode, the port's plain backwards. The criteria of
`test_torch_train.check_train_step_against_reference`. In a file of its
own because the interpret-mode reference takes most of a minute."""

import pytest

from test_torch_train import check_train_step_against_reference, make_batch, restore_gathers

FUSED_TRAIN_FLAGS = dict(
    fuse_pyramid_train=True, fuse_flow_level_train=True, fuse_attention_train=True,
    fuse_pose_encoder_train=True, fuse_disp_encoder_train=True,
)


@pytest.fixture(autouse=True)
def _restore_gathers():
    yield from restore_gathers()


def test_fused_train_step_matches_reference():
    check_train_step_against_reference(make_batch(), "take4", FUSED_TRAIN_FLAGS)


def test_cli_train_runs_the_fused_train_flags_on_cpu(capsys):
    """`cli train` accepts the `_train` flags (the reference refuses only
    the serving ones) and trains with them: 2 steps, finite losses."""
    from davo_tpu_torch.cli.main import main as cli_main

    sets = [arg for flag in FUSED_TRAIN_FLAGS for arg in ("--set", f"model.{flag}=true")]
    rc = cli_main(["train", "--version", "tiny", "--steps", "2", "--device", "cpu", "--worlds", "2",
                   "--world-frames", "6", "--set", "train.log_every=1", *sets])
    out = capsys.readouterr().out
    assert rc == 0 and "step 2:" in out and "nan" not in out
