"""The port's hand-written kernels and their wrappers.

A wrapper that launches a CUDA kernel counts its launches in its
``launches`` attribute, and joins :data:`LAUNCH_COUNTED` where it is
defined (:func:`counts_launches`): code that runs a wrapper's launches
again without calling it (``engine.runner``'s CUDA graphs) counts them
from there."""

LAUNCH_COUNTED = []


def counts_launches(wrapper):
    """``wrapper``, its ``launches`` set to 0 and itself listed in
    :data:`LAUNCH_COUNTED`."""
    wrapper.launches = 0
    LAUNCH_COUNTED.append(wrapper)
    return wrapper
