"""The port's VAE-GAN trainer with the Oobleck discriminator (the hinge)
and the default optimizers (AdamW under the inverse-LR schedule) against
the JAX package's on the CPU: tests/test_torch_vaegan_families.py's gen +
disc step pair and bars, in a file of its own so that each file stays
short.
"""
import pytest
import torch

from test_torch_vaegan_families import gen_and_disc_steps


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_gen_and_disc_steps_with_the_oobleck_discriminator_match_jax():
    gen_and_disc_steps("oobleck", False)
