"""The port's train step against the reference's for the encoder-decoder
(whisper-small), reduced, in float32, from one state through
``state_from_reference``: loss, metrics, every gradient leaf and the
updated state, at 1 and 2 microbatches and with the bf16 gradient cast
(``tests/_torch_train.py``)."""

import pytest

from _torch_models import OTHER
from _torch_train import VARIANTS, check_against_reference, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", OTHER)
def test_train_step_matches_the_reference(arch, variant):
    check_against_reference(arch, variant)
