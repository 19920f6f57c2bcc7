"""The train-step parity of ``test_torch_train.py`` for the other five
architectures (qwen2-vl-7b, seamless-m4t-medium, xlstm-1.3b,
granite-moe-3b-a800m, grok-1-314b), in a file of their own so that each
file's JAX compiles stay near a minute; the rules are that file's."""

import pytest

import train_parity as P

ARCHS = P.ARCHS[5:]


@pytest.mark.parametrize("arch", ARCHS)
def test_step_scalars_match_repro(arch):
    P.check_scalars(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_gradients_and_moments_match_repro(arch):
    P.check_gradients_and_moments(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_parameters_match_repro_where_gradients_agree(arch):
    P.check_parameters_where_gradients_agree(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_repro(arch):
    P.check_bf16_loss(arch)
