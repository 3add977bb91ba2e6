"""The 'cubic_device' route of ``resample`` over the pole and across the
antimeridian, port (``device="cpu"``) against the JAX package: inputs,
checks and tolerances of tests/test_torch_polar.py (a file of its own
because JAX compiles this route for most of a minute per grid shape)."""

import pytest

from test_torch_polar import INPUTS, check_route


@pytest.mark.parametrize("name", INPUTS)
def test_cubic_device_route_matches_jax(name):
    check_route(name, "cubic_device")
