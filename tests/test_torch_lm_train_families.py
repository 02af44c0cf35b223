"""LM training against the JAX reference on the CPU, continued: the MoE
configs (capacity, drops and the aux loss at T = B * S tokens) and the
audio and vision stubs, the parity tests and bars of
``tests/test_torch_lm_train.py`` over this file's ARCHS."""
from test_torch_lm_train import (  # noqa: F401
    pytest_generate_tests, test_eval_step_matches_reference,
    test_loss_and_grads_match_reference, test_resumed_step_matches_reference,
    test_train_step_matches_reference)
from test_torch_pretrain import one_thread_a_process  # noqa: F401

ARCHS = ("granite_moe_3b_a800m", "qwen3_moe_235b_a22b", "musicgen_large",
         "paligemma_3b")
