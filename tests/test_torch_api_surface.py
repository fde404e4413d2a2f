"""The port's public names against the JAX package's.

The port's ``__all__`` equals the JAX package's less the names listed in
``NOT_PORTED``, each with the ROADMAP queue 1 item that ports it (none is
left: the list is empty); every other name resolves in both packages.  A
name taken off the list must then exist in the port.
"""

import pytest

import concrete_tpu as fhe
import concrete_tpu_torch as tfhe

NOT_PORTED: dict = {}


def test_public_names_match_reference():
    assert set(NOT_PORTED) <= set(fhe.__all__)
    assert set(tfhe.__all__) == set(fhe.__all__) - set(NOT_PORTED)
    assert len(tfhe.__all__) == len(set(tfhe.__all__))
    for item in NOT_PORTED.values():
        assert item.startswith("item ")


@pytest.mark.parametrize("name", sorted(set(fhe.__all__)))
def test_public_name_resolves(name):
    """A listed name is missing from the port; every other one resolves,
    to an object of the same kind as the JAX package's."""
    if name in NOT_PORTED:
        assert not hasattr(tfhe, name), f"{name} exists: take it off the list"
        return
    ours, theirs = getattr(tfhe, name), getattr(fhe, name)
    assert callable(ours) == callable(theirs)
    assert isinstance(ours, type) == isinstance(theirs, type)
    if not callable(theirs) and not hasattr(theirs, "__dict__"):
        assert ours == theirs          # the module constants
