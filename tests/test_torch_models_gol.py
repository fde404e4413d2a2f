"""The port's GameOfLife(3, 3) against the JAX package's, on CPU: the
checks of ``tests/test_torch_models.py`` (the same ``ClientSpecs`` and
archive; bit-equal output ciphertexts that decrypt to the model's clear
function), in a file of its own so that a run with one file per worker
gives this model a worker."""

import pytest

from torch_threads import one_intra_op_thread  # noqa: F401
from test_torch_models import check_compile_and_archive, check_run


@pytest.mark.parametrize("name", ["game_of_life"])
def test_model_compile_and_archive_match_reference(tmp_path, name):
    check_compile_and_archive(tmp_path, name)


@pytest.mark.parametrize("name", ["game_of_life"])
def test_model_run_matches_reference(tmp_path, name):
    check_run(tmp_path, name)
