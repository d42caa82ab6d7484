"""Fixtures of the harness's tests.  Whether there is a card is decided
inside a fixture, never while a module is imported."""

import pytest
import torch


@pytest.fixture
def card():
    """The card, or a skip with the reason (tests marked ``cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python -m pytest gpubench/tests -m cuda)")
    return torch.device("cuda:0")
