"""The port's public surface against the JAX package's: every reference
module that has a twin at the same relative path in ``cpprob_tpu_torch``
exports every name of the reference's ``__all__`` (extra names in the
port are allowed).  Both ``__all__`` lists are read with ``ast``, so no
module of either package is imported here."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = os.path.join(ROOT, "cpprob_tpu"), os.path.join(ROOT, "cpprob_tpu_torch")

# reference modules whose kernels were ported into other files of ``ops/``
# (``PERF.md``'s kernel table maps them), so they have no same-path twin
PORTED_ELSEWHERE = {"ops/pallas_hmm.py", "ops/pallas_ssm.py", "ops/pallas_resample.py"}


def _all_names(path):
    """The module's ``__all__`` (with any ``+=``), or None."""
    names = None
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            names = list(ast.literal_eval(node.value))
        elif (isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name)
              and node.target.id == "__all__"):
            names += list(ast.literal_eval(node.value))
    return names


def _reference_modules():
    out = []
    for root, _, files in os.walk(REF):
        for f in sorted(files):
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), REF).replace(os.sep, "/"))
    return sorted(out)


MODULES = _reference_modules()


def test_every_reference_module_has_a_twin():
    missing = [m for m in MODULES
               if m not in PORTED_ELSEWHERE and not os.path.exists(os.path.join(PORT, m))]
    assert not missing, missing


@pytest.mark.parametrize("rel", [m for m in MODULES if m not in PORTED_ELSEWHERE])
def test_twin_exports_every_reference_name(rel):
    ref = _all_names(os.path.join(REF, rel))
    port_path = os.path.join(PORT, rel)
    assert os.path.exists(port_path), rel
    if ref is None:
        return
    port = _all_names(port_path)
    assert port is not None, f"{rel}: the port has no __all__"
    assert not set(ref) - set(port), (rel, sorted(set(ref) - set(port)))


def test_resampler_exports():
    """The three resamplers the reference's ``inference`` exports."""
    from cpprob_tpu_torch.inference import (  # noqa: F401
        multinomial_resample,
        residual_resample,
        stratified_resample,
    )
