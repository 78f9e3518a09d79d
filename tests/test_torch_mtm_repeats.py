"""Parity of the port's delta-scored MTM step with the JAX package on a
repeat (copy-expanded) table: the repeat engine v2 with the MH catalogue
(tests/test_torch_mtm_delta.py's check, on tests/test_delta_repeats.py's
repeat problem), ``corrected`` False and True: decisions equal, states
bit-identical, the carried likelihood at rtol 1e-5, every committed state
valid.
"""

import pytest

from tests.test_torch_mtm_delta import check_delta_steps, delta_setup


@pytest.fixture(scope="module")
def repeats():
    return delta_setup("repeats")


@pytest.mark.parametrize("corrected", [False, True])
def test_delta_mtm_steps_on_repeats_match_jax(repeats, corrected):
    check_delta_steps(repeats, "mtm", corrected)
