"""The port's train step under the banded warp against the JAX package
(CPU, float32, `tiny`, band (2, 4)): the reference runs its Pallas
kernels in interpret mode, the port the kernels' plain versions. The
criteria of `test_torch_train.check_train_step_against_reference`. In a
file of its own because the interpret-mode reference takes minutes."""

import pytest

from test_torch_train import check_train_step_against_reference, make_batch, restore_gathers


@pytest.fixture(autouse=True)
def _restore_gathers():
    yield from restore_gathers()


def test_banded_train_step_matches_reference():
    check_train_step_against_reference(make_batch(), "banded")
