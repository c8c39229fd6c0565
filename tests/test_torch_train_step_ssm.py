"""The port's train step against the reference's for the ssm and hybrid
families (falcon-mamba-7b, hymba-1.5b), reduced, in float32, from one
state through ``state_from_reference``: loss, metrics, every gradient
leaf and the updated state, at 1 and 2 microbatches and with the bf16
gradient cast (``tests/_torch_train.py``). The SSM layers' scan
gradients come from ``SSMScan``'s plain backward here, XLA's autodiff of
``lax.scan`` there."""

import pytest

from _torch_models import SSM
from _torch_train import VARIANTS, check_against_reference, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", SSM)
def test_train_step_matches_the_reference(arch, variant):
    check_against_reference(arch, variant)
