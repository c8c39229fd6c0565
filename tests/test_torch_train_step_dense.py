"""The port's train step against the reference's for the dense family
(reduced, float32, one state through ``state_from_reference``): loss,
metrics, every gradient leaf and the updated state, at 1 and 2
microbatches and with the bf16 gradient cast (``tests/_torch_train.py``)."""

import pytest

from _torch_models import DENSE
from _torch_train import VARIANTS, check_against_reference, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", DENSE)
def test_train_step_matches_the_reference(arch, variant):
    check_against_reference(arch, variant)
