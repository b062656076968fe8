"""The port's debug guards (``molvax_torch/utils.py``) in the cases of
``tests/unit/test_utils.py``: the anomaly flag set and restored, a clean
``checked`` call, a NaN caught with its path; and what torch's idiom adds:
the backward failing at the op that made the NaN, and the refusal under
CUDA-graph capture. No JAX."""

import re

import pytest
import torch

from molvax_torch.utils import assert_finite, checked, debug_mode


@pytest.mark.parametrize("before", [False, True])
@pytest.mark.parametrize("nans", [True, False])
def test_debug_mode_restores_flags(before, nans):
    torch.autograd.set_detect_anomaly(before)
    try:
        with debug_mode(nans=nans, tracer_leaks=True):  # tracer_leaks: no effect in torch
            assert torch.is_anomaly_enabled() is nans
        assert torch.is_anomaly_enabled() is before
        with pytest.raises(ValueError, match="inside"):
            with debug_mode(nans=nans):
                raise ValueError("inside")
        assert torch.is_anomaly_enabled() is before
    finally:
        torch.autograd.set_detect_anomaly(False)


def test_debug_mode_fails_the_backward_at_the_nan():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    torch.sqrt(x).sum().backward()  # NaN gradient, no error by default
    assert torch.isnan(x.grad).any()
    x.grad = None
    with debug_mode():
        with pytest.raises(RuntimeError, match="SqrtBackward0"):
            with pytest.warns(UserWarning):  # anomaly mode names the forward op's trace
                torch.sqrt(x).sum().backward()


def test_checked_passes_clean():
    def f(x):
        assert_finite({"x": x})
        return x + 1

    out = checked(f)(torch.ones(4))
    assert float(out[0]) == 2.0
    assert checked(f).__name__ == "f"


@pytest.mark.parametrize("tree,name,where", [
    ({"x": torch.tensor([1.0, float("nan")])}, "batch", "batch['x']"),
    ([torch.ones(2), {"w": torch.tensor([float("inf")])}], "params", "params[1]['w']"),
    (torch.tensor([float("-inf")]), "loss", "loss"),
])
def test_checked_raises_on_nan(tree, name, where):
    def f(t):
        assert_finite(t, name)
        return t

    with pytest.raises(FloatingPointError, match="non-finite values in " + re.escape(where) + "$"):
        checked(f)(tree)


def test_assert_finite_refuses_to_run_under_capture(monkeypatch):
    """A finiteness check syncs with the host; under CUDA-graph capture it
    raises a clear error instead of breaking the capture."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="CUDA-graph capture"):
        assert_finite({"x": torch.ones(2)}, "batch")
