"""The port's ``RegressionProblem`` against the JAX package's: the same
fields, defaults and order, exported from ``algorithms`` as the
reference exports it."""

import dataclasses

import numpy as np
import pytest

from libskylark_tpu import algorithms as jalg
from libskylark_tpu_torch import algorithms
from libskylark_tpu_torch.algorithms import regression


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_fields_and_defaults_match_reference():
    assert _fields(regression.RegressionProblem) == _fields(
        jalg.RegressionProblem)


def test_exported_from_algorithms():
    assert algorithms.RegressionProblem is regression.RegressionProblem
    assert "RegressionProblem" in algorithms.__all__


@pytest.mark.parametrize("kind,penalty,reg", [
    ("linear", "l2", None), ("kernel", "l1", "l2"),
    ("polynomial", "lp", "l1")])
def test_holds_what_the_reference_holds(kind, penalty, reg):
    A = np.arange(6.0).reshape(3, 2)
    got = regression.RegressionProblem(A, kind, penalty, reg)
    want = jalg.RegressionProblem(A, kind, penalty, reg)
    assert (got.kind, got.penalty, got.regularization) == (
        want.kind, want.penalty, want.regularization)
    assert got.A is A and dataclasses.replace(got, kind="linear").A is A
