"""LM training against the JAX reference on the CPU, continued: zamba2
(Mamba2 blocks on the scan, the shared attention), the parity tests and
bars of ``tests/test_torch_lm_train.py`` over this file's ARCHS."""
from test_torch_lm_train import (  # noqa: F401
    pytest_generate_tests, test_eval_step_matches_reference,
    test_loss_and_grads_match_reference, test_resumed_step_matches_reference,
    test_train_step_matches_reference)
from test_torch_lm_train import assert_dots_remat
from test_torch_pretrain import one_thread_a_process  # noqa: F401

ARCHS = ("zamba2_1p2b",)


def test_remat_policy_dots_matches_reference():
    """``remat_policy="dots"`` on reduced zamba2 (its one repetition of
    the unit: five Mamba2 blocks and the shared attention)."""
    assert_dots_remat("zamba2_1p2b")
